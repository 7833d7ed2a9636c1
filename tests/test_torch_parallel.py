"""Data parallelism in the port (``parallel/dp``, ``mesh``, ``multihost``)
on the CPU: two gloo ranks against one process on the whole batch, and
against the JAX package's data-parallel step on 2 of the 8 virtual devices
(twin of ``tests/test_parallel.py``).

The ranks are subprocesses running this file as a script (``__main__``
below): each joins a gloo group of 2, takes its half of the same
numpy-seeded inputs, and writes what it computed for the parent to compare.
Each rank holds 2 slices of 32x32 (the global batch 4), ``augment=False``.

Tolerances: T1 gradients (read from Adam's first moment, mu = (1 - beta1)
g after one step) rtol 1e-4, atol 1e-6 of g against one process; adapt
gradients rtol 1e-4 of the largest |g| of each tensor (floored at 1e-2 of
the largest of the tree, for the critic's conv biases before an instance
norm, whose gradient is mathematically zero), as ``test_torch_adapt.py``
holds them: through the GAN loss, the frozen HLM and its BN the DAM's
gradients reach 0.3 and carry summation-order noise of ~5e-6 of that; the
loss rtol 1e-4; parameters after the step atol 5e-4 (DAM and segmenter) and
2e-3 (critic, its optimizer state), the reference's own tolerances (Adam's
first step is about lr * sign(g), and where |g| is at rounding level the
sign may differ); BN state atol 1e-5; ``d_acc`` rtol 1e-5.  The ranks'
states are bitwise equal.  Against the JAX package's single-device
gradient: rtol 1e-4 of the largest |g| of each tensor.

The JAX package's T1 data-parallel gradient is N times the single-device
one (its loss ``psum``s transpose to ``psum``s); the port's is the
single-device gradient (``parallel/dp.py``).  Both are pinned here.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcmda_tpu import config as jcfg
from mcmda_tpu.models import critic as jcritic
from mcmda_tpu.models import segmenter as jseg
from mcmda_tpu.parallel import dp as jdp, mesh as jmesh
from mcmda_tpu.train import adapt as jadapt, source as jsource
from mcmda_tpu_torch import config as tcfg, weights
from mcmda_tpu_torch.data import synthetic, volumes
from mcmda_tpu_torch.evaluation import inference
from mcmda_tpu_torch.kernels import train_conv
from mcmda_tpu_torch.parallel import dp, mesh, multihost
from mcmda_tpu_torch.train import adapt, source
from mcmda_tpu_torch.utils import prng, tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
PER_RANK = 2
ADAPT_CASES = {"main": 1.0, "throttled": 0.5}


def _t(x):
    """numpy tree -> torch tree (copies)."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x, np.float32))


def _shard(a, rank):
    return a[rank * PER_RANK:(rank + 1) * PER_RANK]


# ------------------------------------------------------- the rank process
def _t1_state(cfg, inp):
    return dataclasses.replace(source.init_state(0, cfg, "cpu"),
                               params=_t(inp["params"]),
                               bn_state=_t(inp["bn"]))


def _adapt_state(cfg, inp):
    st = adapt.init_state(0, cfg, _t(inp["params"]), _t(inp["bn"]))
    _, tx_d = adapt.make_txs(cfg)
    cp = _t(inp["critic"])
    return dataclasses.replace(st, critic_params=cp,
                               opt_d_state=tx_d.init(cp))


def _sync_bn(inp, group, rank):
    """conv + train-mode BN (the conv + moments path, its plain version on
    the CPU) of this rank's shard, and the gradients of the global loss
    sum(y * r) with respect to the shard and the weights."""
    x = torch.from_numpy(inp["bn_x"])
    w = torch.from_numpy(inp["bn_w"]).requires_grad_()
    r = torch.from_numpy(inp["bn_r"])
    if group is not None:
        x, r = _shard(x, rank), _shard(r, rank)
    x = x.requires_grad_()
    c = x.shape[-1]
    bn_p = {"scale": torch.linspace(0.5, 1.5, c),
            "bias": torch.linspace(-0.2, 0.2, c)}
    bn_s = {"mean": torch.zeros(c), "var": torch.ones(c)}
    y, st = train_conv.conv_bn_act_train({"w": w}, bn_p, bn_s, x,
                                         dilation=2, group=group)
    loss = dp.global_sum((y * r).sum(), group)
    dx, dw = torch.autograd.grad(loss, [x, w])
    return {"y": y.detach(), "mean": st["mean"], "var": st["var"],
            "dx": dx, "dw": dp.reduce_grads({"w": dw}, group)["w"]}


def _rank_main(out_dir, rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank)
    group = mesh.make_mesh(WORLD, "cpu")
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz"),
                       allow_pickle=True))
    for k in ("params", "bn", "critic"):
        inp[k] = inp[k].item()
    with open(os.path.join(out_dir, "configs.json")) as f:
        cfgs = {k: tcfg.ExperimentConfig.from_json(v)
                for k, v in json.load(f).items()}
    res = {}

    t1 = dp.data_parallel_step(
        source.make_train_step(cfgs["t1"], group=group, augment=False), group)
    s1, m = t1(_t1_state(cfgs["t1"], inp),
               {"image": torch.from_numpy(_shard(inp["x"], rank)),
                "label": torch.from_numpy(_shard(inp["lab"], rank))}, 0)
    res.update({f"t1/{k}": v for k, v in weights.flatten_state(s1).items()})
    res.update({f"t1m/{k}": float(v) for k, v in m.items()})

    for case in ADAPT_CASES:
        step = dp.data_parallel_step(adapt.make_adapt_step(
            cfgs[case], group=group, augment=False), group)
        s1, m = step(_adapt_state(cfgs[case], inp),
                     {"src_image": torch.from_numpy(_shard(inp["src"], rank)),
                      "tgt_image": torch.from_numpy(_shard(inp["tgt"], rank))},
                     0)
        res.update({f"{case}/{k}": v
                    for k, v in weights.flatten_state(s1).items()})
        res.update({f"{case}m/{k}": float(v) for k, v in m.items()})

    res.update({f"bn/{k}": v.numpy()
                for k, v in _sync_bn(inp, group, rank).items()})

    # the step's seed as each rank's step function sees it
    seen = []
    dp.data_parallel_step(lambda st, b, seed: (seen.append(seed) or st, {}),
                          group)(None, None, 123)
    res["seed"] = np.asarray(seen[0], np.uint64)

    # rank 0's state on every rank, whatever rank 1 held
    st = _t1_state(cfgs["t1"], inp)
    if rank == 1:
        st = dataclasses.replace(
            st, params=tree.tree_map(lambda t: t + 1.0, st.params))
    rep = multihost.replicate(st, group)
    res.update({f"rep/{k}": v for k, v in weights.flatten_state(rep).items()})

    raw = source.make_eval_forward(cfgs["t1"])
    res["masks"] = inference.predict_volume(
        lambda img, p, b: raw(p, b, img), inp["vol"], context=3,
        batch_size=4, fwd_args=(_t(inp["params"]), _t(inp["bn"])),
        device="cpu", mesh=group)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


# ----------------------------------------------------------------- parent
def _fill(shapes, rng):
    """Seeded numpy leaves: He-normal convs, perturbed BN affine,
    non-trivial BN statistics, small biases."""
    def fill(kp, leaf):
        name = jax.tree_util.keystr(kp)
        if name.endswith("['w']"):
            a = rng.standard_normal(leaf.shape) * np.sqrt(
                2.0 / np.prod(leaf.shape[:-1]))
        elif name.endswith("['scale']"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        elif name.endswith("['var']"):
            a = rng.uniform(0.5, 2.0, leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _configs(tiny_config):
    with open(os.path.join(REPO, "configs", "mri2ct.json")) as f:
        shipped = jcfg.ExperimentConfig.from_json(f.read()).adapt
    out = {"t1": tiny_config}
    for case, cap in ADAPT_CASES.items():
        out[case] = dataclasses.replace(tiny_config, adapt=dataclasses.replace(
            shipped, plug_depth="rm2", src_feats_bf16=False, d_acc_cap=cap))
    return out


def _inputs(cfg):
    rng = np.random.default_rng(11)
    params, bn = _fill(jax.eval_shape(
        lambda: jseg.init(jax.random.key(0), cfg.segmenter)), rng)
    critic = _fill(jax.eval_shape(lambda: jcritic.init(
        jax.random.key(0), cfg.critic, cfg.segmenter)), rng)
    n, s = WORLD * PER_RANK, cfg.data.slice_size
    lab = (np.arange(s)[None, :, None] // (s // 4)
           + np.arange(s)[None, None, :] // (s // 2)
           + rng.integers(0, 2, (n, 1, 1))) % 5
    return {
        "params": jax.tree.map(np.asarray, params),
        "bn": jax.tree.map(np.asarray, bn),
        "critic": jax.tree.map(np.asarray, critic),
        "x": rng.normal(size=(n, s, s, 3)).astype(np.float32),
        "lab": np.eye(5, dtype=np.float32)[lab],
        "src": rng.normal(size=(n, s, s, 3)).astype(np.float32),
        "tgt": (0.5 + 1.5 * rng.normal(size=(n, s, s, 3))).astype(np.float32),
        "bn_x": rng.normal(size=(n, 8, 8, 16)).astype(np.float32),
        "bn_w": (0.1 * rng.normal(size=(3, 3, 16, 16))).astype(np.float32),
        "bn_r": rng.normal(size=(n, 8, 8, 16)).astype(np.float32),
        "vol": rng.normal(size=(12, s, s)).astype(np.float32),
    }


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tiny_config, tmp_path_factory):
    """The inputs, the configs, and what each of 2 gloo ranks computed."""
    out = tmp_path_factory.mktemp("dp")
    cfgs = _configs(tiny_config)
    inp = _inputs(tiny_config)
    np.savez(out / "inputs.npz", **{k: np.asarray(v, dtype=object)
                                    if isinstance(v, dict) else v
                                    for k, v in inp.items()})
    with open(out / "configs.json", "w") as f:
        json.dump({k: c.to_json() for k, c in cfgs.items()}, f)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out), str(r),
         str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return {"cfgs": cfgs, "inp": inp, "ranks": ranks}


def _part(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _jflat(state):
    """A JAX state in the port's checkpoint layout (keystr names)."""
    return {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in
            jax.tree_util.tree_flatten_with_path(state)[0]}


def _close(got, want, keys, atol, rtol=0.0):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=k)


def _keys(flat, part, field=None):
    return [k for k in flat if k.startswith(part)
            and (field is None or field in k)]


def _batch(inp, *keys):
    return {k: torch.from_numpy(inp[v]) for k, v in keys}


# ------------------------------------------------------------------- T1
def test_t1_dp_matches_single_device(run):
    """2 ranks == one process on the batch of 4: gradients (not twice
    them), loss, parameters after Adam, BN state."""
    cfg = tcfg.ExperimentConfig.from_json(run["cfgs"]["t1"].to_json())
    inp = run["inp"]
    s1, m = source.make_train_step(cfg, augment=False)(
        _t1_state(cfg, inp), _batch(inp, ("image", "x"), ("label", "lab")), 0)
    one = weights.flatten_state(s1)
    got = _part(run["ranks"][0], "t1")
    b1 = cfg.source.beta1
    for k in _keys(one, ".opt_state[0].mu"):
        np.testing.assert_allclose(got[k] / (1 - b1), one[k] / (1 - b1),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k, v in m.items():
        np.testing.assert_allclose(run["ranks"][0][f"t1m/{k}"], float(v),
                                   rtol=1e-4, err_msg=k)
    _close(got, one, _keys(one, ".params"), 5e-4)
    _close(got, one, _keys(one, ".bn_state"), 1e-5)
    assert int(got[".step"]) == 1


def test_t1_dp_matches_jax_dp_step(run):
    """The JAX data-parallel step on 2 virtual devices from the same
    weights and shards: the parameters after one step agree (Adam hides the
    JAX gradient's scale), the port's gradient is the JAX single-device
    gradient, and the JAX data-parallel gradient is twice it."""
    cfg, inp = run["cfgs"]["t1"], run["inp"]
    params = jax.tree.map(jnp.asarray, inp["params"])
    j0 = jsource.SourceState(params=params,
                             bn_state=jax.tree.map(jnp.asarray, inp["bn"]),
                             opt_state=jsource.make_tx(cfg).init(params),
                             step=jnp.zeros((), jnp.int32))
    batch = {"image": jnp.asarray(inp["x"]), "label": jnp.asarray(inp["lab"])}
    j_dp = _jflat(jdp.data_parallel_step(
        jsource.make_train_step(cfg, axis_name="data", augment=False),
        jmesh.make_mesh(WORLD), donate=False)(j0, batch,
                                              jax.random.key(0))[0])
    j_one = _jflat(jax.jit(jsource.make_train_step(cfg, augment=False))(
        j0, batch, jax.random.key(0))[0])
    got = _part(run["ranks"][0], "t1")
    _close(got, j_dp, _keys(j_one, ".params"), 5e-4)
    for k in _keys(j_one, ".opt_state[0].mu"):
        want = j_one[k]
        np.testing.assert_allclose(got[k], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)
        np.testing.assert_allclose(j_dp[k], WORLD * want, rtol=1e-4,
                                   atol=1e-4 * WORLD * np.abs(want).max(),
                                   err_msg=k)


# ---------------------------------------------------------------- adapt
def _port_adapt_single(cfg, inp):
    t_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    s1, m = adapt.make_adapt_step(t_cfg, augment=False)(
        _adapt_state(t_cfg, inp),
        _batch(inp, ("src_image", "src"), ("tgt_image", "tgt")), 0)
    return weights.flatten_state(s1), {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("case", list(ADAPT_CASES))
def test_adapt_dp_matches_single_device(run, case):
    """The main branch and the throttled one (cap 0.5, decided on the
    global accuracy): 2 ranks == one process on the batch of 4."""
    cfg, inp = run["cfgs"][case], run["inp"]
    one, m = _port_adapt_single(cfg, inp)
    got = _part(run["ranks"][0], case)
    np.testing.assert_allclose(run["ranks"][0][f"{case}m/d_acc"],
                               m["d_acc"], rtol=1e-5)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(run["ranks"][0][f"{case}m/{k}"], m[k],
                                   rtol=1e-4, err_msg=k)
    for opt in (".opt_d_state[0].mu", ".opt_g_state[0].mu"):
        keys = _keys(one, opt)
        floor = 1e-2 * max(np.abs(one[k]).max() for k in keys)
        for k in keys:
            scale = max(np.abs(one[k]).max(), floor)
            np.testing.assert_allclose(got[k], one[k], rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=k)
    _close(got, one, _keys(one, ".dam_params"), 5e-4)
    _close(got, one, _keys(one, ".critic_params")
           + _keys(one, ".opt_d_state"), 2e-3)
    _close(got, one, _keys(one, ".tgt_bn"), 1e-5)


@pytest.mark.parametrize("case", list(ADAPT_CASES))
def test_adapt_dp_matches_jax_dp_step(run, case):
    cfg, inp = run["cfgs"][case], run["inp"]
    j = jadapt.init_state(jax.random.key(1), cfg, inp["params"], inp["bn"])
    _, tx_d = jadapt.make_txs(cfg)
    jc = jax.tree.map(jnp.asarray, inp["critic"])
    j = j.replace(critic_params=jc, opt_d_state=tx_d.init(jc))
    j1, jm = jdp.data_parallel_step(
        jadapt.make_adapt_step(cfg, axis_name="data", augment=False),
        jmesh.make_mesh(WORLD), donate=False)(
        j, {"src_image": jnp.asarray(inp["src"]),
            "tgt_image": jnp.asarray(inp["tgt"])}, jax.random.key(0))
    want = _jflat(j1)
    got = _part(run["ranks"][0], case)
    np.testing.assert_allclose(run["ranks"][0][f"{case}m/d_acc"],
                               float(jm["d_acc"]), rtol=1e-5)
    _close(got, want, _keys(want, ".dam_params"), 5e-4)
    _close(got, want, _keys(want, ".critic_params")
           + _keys(want, ".opt_d_state"), 2e-3)


def test_dp_ranks_states_bitwise_equal(run):
    r0, r1 = run["ranks"]
    assert set(r0) == set(r1)
    for k in r0:
        if k.split("/")[0] in ("t1", "t1m", "main", "mainm", "throttled",
                               "throttledm", "rep", "masks"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


# ------------------------------------------------------- the collectives
def test_sync_bn_conv_bn_act_train_matches_concatenated_batch(run):
    """Sync-BN through the conv + moments path: each rank's output,
    running statistics and gradients (through the moments' all-reduce and
    its backward) equal BN on the concatenated batch."""
    want = {k: v.numpy() for k, v in _sync_bn(run["inp"], None, 0).items()}
    for rank, res in enumerate(run["ranks"]):
        got = _part(res, "bn")
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], _shard(want[k], rank),
                                       atol=1e-5, err_msg=k)
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["dw"], want["dw"], rtol=1e-4,
                                   atol=1e-4 * np.abs(want["dw"]).max())


def test_rank_seeds_differ(run):
    """Each rank folds its rank into the step's seed: no two ranks draw
    one stream."""
    seeds = [int(r["seed"]) for r in run["ranks"]]
    assert seeds == [prng.fold_in(123, r) for r in range(WORLD)]
    assert len(set(seeds + [123])) == WORLD + 1


def test_replicate_gives_every_rank_rank0_state(run):
    """Rank 1 held other parameters; after ``replicate`` both hold rank
    0's, bit for bit."""
    want = weights.flatten_state(_t1_state(
        tcfg.ExperimentConfig.from_json(run["cfgs"]["t1"].to_json()),
        run["inp"]))
    for res in run["ranks"]:
        got = _part(res, "rep")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_predict_volume_sharded_matches_single(run):
    """Each batch of 4 split over the 2 ranks and gathered: the masks of
    one process, slice for slice."""
    cfg = tcfg.ExperimentConfig.from_json(run["cfgs"]["t1"].to_json())
    inp = run["inp"]
    raw = source.make_eval_forward(cfg)
    want = inference.predict_volume(
        lambda img, p, b: raw(p, b, img), inp["vol"], context=3,
        batch_size=4, fwd_args=(_t(inp["params"]), _t(inp["bn"])),
        device="cpu")
    for res in run["ranks"]:
        np.testing.assert_array_equal(res["masks"], want)


def test_shard_dataset_partitions(monkeypatch):
    """Trimmed to a multiple of the device count, the ranks' ranges
    partition the trimmed dataset in order."""
    vols, labs = synthetic.make_dataset(0, "mri", 2, 8, 16)
    ds = volumes.volumes_to_slices(vols, labs)
    n_dev = 4
    got = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: n_dev)
    for rank in range(n_dev):
        monkeypatch.setattr(dist, "get_rank", lambda *a, r=rank: r)
        got.append(multihost.shard_dataset(ds, n_dev))
    assert len({len(s) for s in got}) == 1
    total = sum(len(s) for s in got)
    assert total == (len(ds) // n_dev) * n_dev
    np.testing.assert_array_equal(
        np.concatenate([s.images for s in got]), ds.images[:total])


def test_make_mesh_beyond_the_devices_raises():
    """No virtual-CPU fallback (the opposite of the JAX package's
    ``test_make_mesh_falls_back_to_cpu``, on purpose): a cuda run with more
    ranks than CUDA devices raises, and so does a group of another size."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="more ranks than devices"):
        mesh.make_mesh(n, "cuda")
    with pytest.raises(ValueError, match="process group has 1 rank"):
        mesh.make_mesh(2, "cpu")


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
