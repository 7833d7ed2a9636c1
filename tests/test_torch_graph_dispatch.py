"""The port's one-dispatch serving, probe and sweep paths against the JAX
package, on the CPU, at a tiny width.

On the CPU every such path runs eagerly (``drivers.dispatch`` says
"eager"); on a GPU the same functions are CUDA graphs, held bitwise to
their eager runs by ``tests/test_torch_kernel_gpu.py`` and the smoke.
Serving: the port's ``predict_volume`` (single dispatch and the batch
loop) against ``mcmda_tpu``'s ``predict_volume(single_dispatch=True)`` on
converted weights, a volume of 11 slices at batch 4 (pad rows) and context
3 and 5; in f32 the masks must be equal up to argmax near-ties, at most
0.01% of voxels, as ``tests/test_torch_predict.py`` states.  The counts:
the one-hot forms equal the ``bincount`` forms they replace, exactly.
"""

import jax
import numpy as np
import pytest
import torch

from mcmda_tpu import config as jcfg
from mcmda_tpu.evaluation import inference as jinf
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.train import source as jsource
from mcmda_tpu.utils.checkpoint import _flatten
from mcmda_tpu_torch import config as tcfg
from mcmda_tpu_torch import weights
from mcmda_tpu_torch.evaluation import inference, report
from mcmda_tpu_torch.models import segmenter as tseg
from mcmda_tpu_torch.ops.metrics import class_counts
from mcmda_tpu_torch.scripts import seed_sweep
from mcmda_tpu_torch.train import drivers, source
from mcmda_tpu_torch.utils import cuda_graph

STAGES = (
    jcfg.StageSpec("stem", 8, 1, 1, 1),
    jcfg.StageSpec("rm1", 8, 2, 1, 1),
    jcfg.StageSpec("rm2", 16, 2, 1, 1),
    jcfg.StageSpec("rm3", 16, 1, 2, 1),
)
SLICES, SIZE, BATCH = 11, 32, 4


def _nets(root, context):
    """The same seeded source weights in both packages for ``context``
    input slices: a JAX ``SourceState`` written as npz in its own layout and
    read back through ``mcmda_tpu_torch.weights``; and an 11-slice
    volume."""
    cfg = jcfg.ExperimentConfig(
        segmenter=jcfg.SegmenterConfig(stages=STAGES, thin_layout="nhwc",
                                       in_channels=context),
        data=jcfg.DataConfig(slice_size=SIZE, batch_size=BATCH,
                             context_slices=context))
    rng = np.random.default_rng(context)
    shapes = jax.eval_shape(lambda: jseg.init(jax.random.key(0),
                                              cfg.segmenter))

    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            a = rng.standard_normal(leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name.endswith("['var']"):
            a = rng.uniform(1.0, 3.0, leaf.shape)
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.0, leaf.shape)
        else:
            a = 0.2 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    params, bn = jax.tree_util.tree_map_with_path(fill, shapes)
    st = jsource.SourceState(params=params, bn_state=bn, opt_state=None,
                             step=np.int32(1))
    path = str(root / f"step_0000000{context}.npz")
    np.savez(path, **_flatten(st))
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tp, tb = weights.restore_source(path, t_cfg, "cpu")
    vol = rng.normal(size=(SLICES, SIZE, SIZE)).astype(np.float32)
    return dict(cfg=cfg, t_cfg=t_cfg, jp=st.params, jb=st.bn_state, tp=tp,
                tb=tb, vol=vol)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    root = tmp_path_factory.mktemp("graph")
    return {c: _nets(root, c) for c in (3, 5)}


def _forwards(m, variant):
    """(JAX forward, port forward, JAX fwd_args, port fwd_args)."""
    seg, t_seg = m["cfg"].segmenter, m["t_cfg"].segmenter
    if variant == "flip+fwd_args":
        def jf(x, p, b):
            return jseg.apply(p, b, x, seg, train=False)[1]

        def tf(x, p, b):
            return tseg.apply(p, b, x, t_seg)[1]

        return (jinf.tta_flip(jf), inference.tta_flip(tf),
                (m["jp"], m["jb"]), (m["tp"], m["tb"]))

    def jf(x):
        return jseg.apply(m["jp"], m["jb"], x, seg, train=False)[1]

    def tf(x):
        return tseg.apply(m["tp"], m["tb"], x, t_seg)[1]

    if variant == "flip":
        return jinf.tta_flip(jf), inference.tta_flip(tf), (), ()
    return jf, tf, (), ()


@pytest.mark.parametrize("context", [3, 5])
@pytest.mark.parametrize("variant", ["plain", "flip", "flip+fwd_args"])
def test_predict_volume_matches_jax_single_dispatch(nets, variant, context):
    """Both port paths equal each other and the JAX package's one-dispatch
    volume up to near-ties.  flip+fwd_args failed before ``tta_flip``
    passed the forward's extra arguments on."""
    m = nets[context]
    jf, tf, j_args, t_args = _forwards(m, variant)
    want = jinf.predict_volume(jf, m["vol"], context=context,
                               batch_size=BATCH, single_dispatch=True,
                               fwd_args=j_args)
    got = {sd: inference.predict_volume(
        tf, m["vol"], context=context, batch_size=BATCH,
        single_dispatch=sd, fwd_args=t_args, device="cpu")
        for sd in (True, False)}
    assert got[True].dtype == np.int32 and got[True].shape == want.shape
    np.testing.assert_array_equal(got[True], got[False])
    assert int((got[True] != want).sum()) <= int(1e-4 * want.size)


def test_tta_flip_is_memoised_per_forward_and_bounded(monkeypatch):
    monkeypatch.setattr(inference, "_tta_cache", {})

    def f(x):
        return x

    assert inference.tta_flip(f) is inference.tta_flip(f)
    fwds = [lambda x: x for _ in range(inference._SCAN_CACHE_MAX + 5)]
    for g in fwds:
        inference.tta_flip(g)
    assert len(inference._tta_cache) == inference._SCAN_CACHE_MAX
    assert fwds[-1] in inference._tta_cache and f not in inference._tta_cache


def test_scan_cache_is_an_lru_of_32(monkeypatch):
    """Keyed on the forward object; a hit returns the same runner and
    moves it to the most recent end; a miss beyond 32 entries evicts the
    least recently used."""
    monkeypatch.setattr(inference, "_scan_cache", {})
    assert inference._SCAN_CACHE_MAX == 32
    key = ((SLICES, SIZE, SIZE), torch.device("cpu"), False)
    fwds = [lambda x: x for _ in range(33)]
    runs = [inference._scanned_argmax(f, key, 3, BATCH) for f in fwds[:32]]
    cache = inference._scan_cache
    assert len(cache) == 32 and list(cache)[0][0] is fwds[0]
    assert inference._scanned_argmax(fwds[0], key, 3, BATCH) is runs[0]
    assert list(cache)[-1][0] is fwds[0]
    inference._scanned_argmax(fwds[32], key, 3, BATCH)
    held = [k[0] for k in cache]
    assert len(cache) == 32 and fwds[1] not in held
    assert fwds[0] in held and fwds[32] in held
    assert inference._scanned_argmax(fwds[0], key, 5, BATCH) is not runs[0]


def test_evaluate_volumes_passes_single_dispatch_through(nets, monkeypatch):
    m = nets[3]
    _, tf, _, _ = _forwards(m, "plain")
    labels = np.random.default_rng(1).integers(0, 5, m["vol"].shape)
    seen = []
    real = inference.predict_volume

    def spy(*a, **kw):
        seen.append(kw["single_dispatch"])
        return real(*a, **kw)

    monkeypatch.setattr(inference, "predict_volume", spy)
    tables = [report.evaluate_volumes(tf, [m["vol"]], [labels],
                                      batch_size=BATCH, single_dispatch=sd,
                                      device="cpu") for sd in (True, False)]
    assert seen == [True, False]
    assert tables[0] == tables[1]
    assert report.evaluate_volumes.__kwdefaults__["single_dispatch"] is True


def test_one_hot_counts_equal_the_bincount_forms():
    """The sweep's intersection / predicted counts and the probe's class
    counts, against the ``torch.bincount`` forms they replace, on seeded
    predictions whose labels hold -1 padding rows."""
    rng = np.random.default_rng(2)
    preds = torch.from_numpy(rng.integers(0, 5, (12, 8, 8)))
    labels = torch.from_numpy(rng.integers(0, 5, (12, 8, 8)))
    labels[-3:] = -1
    inter, psum = seed_sweep._counts(preds, labels, 5)
    flat_p, flat_l = preds.reshape(-1), labels.reshape(-1)
    assert torch.equal(inter, torch.bincount(flat_p[flat_p == flat_l],
                                             minlength=5).float())
    assert torch.equal(psum, torch.bincount(flat_p, minlength=5).float())
    assert torch.equal(class_counts(labels, 5),
                       torch.bincount(flat_l[flat_l >= 0], minlength=5))
    assert torch.equal(class_counts(preds[:5], 7),
                       torch.bincount(preds[:5].reshape(-1), minlength=7))


def test_host_sampler_step_is_graphed_on_a_gpu_only(nets):
    """``feed_line`` and ``wrap_dp`` agree with ``dispatch``: a fed CUDA
    graph of one step on a GPU (built, not run: there is none here), the
    eager step on the CPU."""
    assert drivers.feed_line(False, 1, device="cuda") == \
        "feed path: host-sampler; one step per call on a CUDA graph"
    assert drivers.feed_line(False, 1, device="cpu") == \
        "feed path: host-sampler; one eager step per call"
    cfg = nets[3]["t_cfg"]
    gpu_step = drivers.wrap_dp(cfg, source.make_train_step, device="cuda")[0]
    assert isinstance(gpu_step, cuda_graph.GraphedSteps)
    assert gpu_step.fed and gpu_step.inner == 1
    assert gpu_step.donate == cfg.run.donate
    cpu_step = drivers.wrap_dp(cfg, source.make_train_step, device="cpu")[0]
    assert not isinstance(cpu_step, cuda_graph.GraphedSteps)
    with pytest.raises(ValueError, match="one step per call"):
        cuda_graph.GraphedSteps(lambda *a: a, 2, fed=True)


def test_eager_call_runs_the_function_on_its_inputs():
    seen = []

    def fn(x, d):
        seen.append((x.device, d["w"].device))
        return x + d["w"]

    run = cuda_graph.call(fn, None, torch.device("cpu"), graph=False)
    out = run(torch.ones(3), {"w": torch.full((3,), 2.0)})
    assert torch.equal(out, torch.full((3,), 3.0))
    assert seen == [(torch.device("cpu"), torch.device("cpu"))]
