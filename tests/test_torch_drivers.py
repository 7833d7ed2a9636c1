"""The port's execution drivers, host feed, profiling helpers, device
helper and checkpoint discovery, on the CPU.

Held against the JAX package where it has the same function:
``augment_batch_host`` / ``host_augmented`` on the same
``np.random.default_rng(seed)`` stream (atol 1e-6: both are the same scipy
calls on f32 arrays).  The rest is held to its contract: the drivers return
the plain step and feed on one device and raise for data parallelism; the
prefetching feed yields every batch once, in order; a run directory whose
newest step is an orbax directory resumes from it where ``tensorstore``
reads it and is refused where it cannot, never restarted from an older
step or step 0; every entry point reaches the device helper.
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from mcmda_tpu.data import pipeline as jpipe
from mcmda_tpu_torch import api, cli as tcli, config as tcfg
from mcmda_tpu_torch.data import pipeline, synthetic, volumes
from mcmda_tpu_torch.evaluation import inference, report
from mcmda_tpu_torch.train import adapt, drivers, loop, source
from mcmda_tpu_torch.utils import checkpoint, device as device_mod, profiling


def _port_cfg(cfg):
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


# ------------------------------------------------------------------ drivers
def test_host_seed_differs_per_rank(monkeypatch):
    """Streaming feeds must draw different batches per process."""
    dist = torch.distributed
    assert drivers.host_seed(7) == 7 and drivers.is_primary()
    assert not drivers.multihost_active()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    seeds = set()
    for rank in range(4):
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        seeds.add(drivers.host_seed(7))
        assert drivers.is_primary() == (rank == 0)
    assert len(seeds) == 4 and drivers.multihost_active()


@pytest.mark.parametrize("dp", [0, 1])
def test_feed_plumbing_matches_wrap_dp(tiny_config, dp):
    """feed_plumbing (the input half of api.adapt's streaming branch)
    agrees with wrap_dp on the per-host batch size, and both feeds move a
    sampler's batches to the device asked for."""
    cfg = _port_cfg(tiny_config)
    per, to_dev = drivers.feed_plumbing(cfg, dp, device="cpu")
    step, per_wrap, to_dev_wrap = drivers.wrap_dp(
        cfg, adapt.make_adapt_step, dp, device="cpu", train_g=False)
    assert per == per_wrap == cfg.data.batch_size and callable(step)
    assert drivers.batch_sharding_for(dp) is None
    for fn in (to_dev, to_dev_wrap):
        out = next(fn(iter([{"x": np.ones((2, 3))}])))
        assert out["x"].dtype == torch.float32 and out["x"].device.type == "cpu"


def test_device_resident_dp_builds_the_sampling_step(tiny_config):
    cfg = _port_cfg(tiny_config)
    vols, labs = synthetic.make_dataset(0, "mri", 1, 8, 32)
    ds = volumes.volumes_to_slices(vols, labs, context=3, drop_empty=True)
    seen = []

    def make_data(sharding):
        seen.append(sharding)
        return pipeline.to_device_arrays(ds, cfg.data.num_classes, "cpu")

    step, data = drivers.device_resident_dp(cfg, source.make_train_step, 0,
                                            make_data)
    assert seen == [None] and set(data) == {"images", "labels"}
    state, m = step(source.init_state(0, cfg, "cpu"), data, 3)
    assert int(state.step) == 1 and np.isfinite(float(m["loss"]))


_DP_CALLS = {
    "feed_plumbing": lambda cfg, dp: drivers.feed_plumbing(cfg, dp, "cpu"),
    "wrap_dp": lambda cfg, dp: drivers.wrap_dp(
        cfg, source.make_train_step, dp, device="cpu"),
    "device_resident_dp": lambda cfg, dp: drivers.device_resident_dp(
        cfg, source.make_train_step, dp, lambda _shd: {}),
    "batch_sharding_for": lambda cfg, dp: drivers.batch_sharding_for(dp),
}


@pytest.mark.parametrize("name", list(_DP_CALLS))
def test_data_parallel_raises(tiny_config, monkeypatch, name):
    """dp > 1, or a process group of more than one process, raises in
    every function of drivers.py: none runs on one device instead."""
    cfg = _port_cfg(tiny_config)
    with pytest.raises(NotImplementedError, match="not ported"):
        _DP_CALLS[name](cfg, 2)
    _DP_CALLS[name](cfg, 0)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    with pytest.raises(NotImplementedError, match="not ported"):
        _DP_CALLS[name](cfg, 0)


def test_api_data_parallel_raises(tiny_config):
    cfg = _port_cfg(tiny_config)
    vols, labs = synthetic.make_dataset(0, "mri", 1, 8, 32)
    with pytest.raises(NotImplementedError, match="not ported"):
        api.train_source(cfg, vols, labs, steps=1, dp=2, device="cpu")


# ---------------------------------------------------------------- host feed
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_yields_every_batch_once_in_order(size):
    pulled = []

    def stream():
        for i in range(5):
            pulled.append(i)
            yield {"image": np.full((2, 3), i, np.float64),
                   "label": np.full((2,), -i, np.float32)}

    out = []
    for i, b in enumerate(pipeline.prefetch_to_device(stream(), size=size,
                                                      device="cpu")):
        # `size` batches in flight: the stream runs size - 1 ahead
        assert len(pulled) == min(5, i + size)
        out.append(b)
    assert len(out) == 5  # the queue drains at the end
    for i, b in enumerate(out):
        assert set(b) == {"image", "label"}
        assert b["image"].dtype == b["label"].dtype == torch.float32
        assert torch.equal(b["image"], torch.full((2, 3), float(i)))
        assert torch.equal(b["label"], torch.full((2,), -float(i)))


def test_prefetch_feeds_the_loop(tiny_config, tmp_path):
    """The host-sampler feed drives loop.run, and the run resumes."""
    cfg = _port_cfg(tiny_config)
    vols, labs = synthetic.make_dataset(0, "mri", 1, 8, 32)
    ds = volumes.volumes_to_slices(vols, labs)
    feed = drivers.feed(iter(pipeline.BatchSampler(ds, 4, seed=0,
                                                   num_classes=5)), "cpu")
    state, _ = loop.run(source.make_train_step(cfg, augment=False),
                        source.init_state(0, cfg, "cpu"), feed, 4,
                        ckpt_every=2, ckpt_dir=str(tmp_path), log_every=0)
    resumed, start = loop.maybe_resume(str(tmp_path),
                                       source.init_state(0, cfg, "cpu"))
    assert start == 4 and int(resumed.step) == int(state.step) == 4


def _host_aug_inputs():
    img = np.zeros((2, 16, 16, 3), np.float32)
    img[:, 4:12, 4:12, :] = 1.0
    img += np.random.default_rng(1).normal(size=img.shape).astype(
        np.float32) * 0.1
    lab = np.eye(5, dtype=np.float32)[
        np.pad(np.ones((2, 8, 8), np.int32), ((0, 0), (4, 4), (4, 4)))]
    return img, lab


def test_augment_batch_host_matches_jax_package():
    from mcmda_tpu.config import DataConfig as JDataConfig
    kw = dict(slice_size=16, batch_size=2, rotate_degrees=15.0,
              shift_pixels=2.0)
    img, lab = _host_aug_inputs()
    for labels in (lab, None):
        want = jpipe.augment_batch_host(np.random.default_rng(3), img, labels,
                                        JDataConfig(**kw))
        got = pipeline.augment_batch_host(np.random.default_rng(3), img,
                                          labels, tcfg.DataConfig(**kw))
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        if labels is None:
            assert got[1] is None and want[1] is None
        else:
            np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    assert not np.allclose(got[0], img)  # it did warp


def test_host_augmented_matches_jax_package():
    from mcmda_tpu.config import DataConfig as JDataConfig
    kw = dict(slice_size=16, batch_size=2, rotate_degrees=15.0,
              shift_pixels=2.0)
    img, lab = _host_aug_inputs()

    def stream():
        for _ in range(2):
            yield {"image": img.copy(), "label": lab.copy(),
                   "tgt_image": img[::-1].copy()}

    args = dict(seed=5, keys=("image", "tgt_image"))
    want = list(jpipe.host_augmented(stream(), JDataConfig(**kw), **args))
    got = list(pipeline.host_augmented(stream(), tcfg.DataConfig(**kw),
                                       **args))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, err_msg=k)
    # image-only key path, no label key
    out = next(pipeline.host_augmented(iter([{"src_image": img.copy()}]),
                                       tcfg.DataConfig(**kw),
                                       keys=("src_image",), label_key=None))
    assert out["src_image"].shape == img.shape


# ----------------------------------------------------------------- fwd_args
def test_fwd_args_equals_the_closure_form():
    vols, labs = synthetic.make_dataset(1, "ct", 2, 6, 24)
    edges = torch.tensor([-0.5, 0.0, 0.5, 1.0])

    def fwd(img, edges_, shift):
        cls = (img[..., 1:2] + shift > edges_).sum(-1)
        return torch.nn.functional.one_hot(cls, 5).float()

    kw = dict(context=3, batch_size=4, device="cpu")
    want = inference.predict_volume(lambda x: fwd(x, edges, 0.1), vols[0],
                                    **kw)
    got = inference.predict_volume(fwd, vols[0], fwd_args=(edges, 0.1), **kw)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 2
    t_want = report.evaluate_volumes(lambda x: fwd(x, edges, 0.1), vols, labs,
                                     **kw)
    t_got = report.evaluate_volumes(fwd, vols, labs, fwd_args=(edges, 0.1),
                                    **kw)
    assert t_got["mean"] == t_want["mean"]
    assert t_got["per_volume"] == t_want["per_volume"]


# ---------------------------------------------------------------- profiling
def test_step_timer():
    t = profiling.StepTimer(batch_size=8, num_devices=2, window=3)
    assert t.slices_per_sec_per_chip == 0.0
    for _ in range(5):
        t.tick({"loss": torch.zeros(()), "aux": (torch.ones(2),)})
        time.sleep(0.01)
    assert len(t._t) == 4  # window + 1 boundaries
    rate = t.slices_per_sec_per_chip
    assert 0 < rate < 8 / 0.01 / 2


@pytest.mark.parametrize("spans,want", [
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),                  # overlapping
    ([(0.0, 10.0), (2.0, 3.0), (4.0, 5.0)], 10.0),    # nested
    ([(5.0, 6.0), (0.0, 1.0), (2.0, 2.5)], 2.5),      # disjoint, unsorted
    ([(0.0, 1.0), (1.0, 2.0), (0.5, 1.5), (7.0, 7.0)], 2.0),  # touching
    ([], 0.0),
])
def test_busy_time_is_the_union_of_intervals(spans, want):
    assert profiling.busy_time(spans) == pytest.approx(want)
    assert profiling.busy_time(iter(spans)) == pytest.approx(want)


def test_trace_writes_a_chrome_trace(tmp_path):
    import json
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_measure_step_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises((RuntimeError, AssertionError)):
        profiling.measure_step(lambda s, d, k: (s, {}), 0, {})


# ------------------------------------------------- F1: orbax run directories
def _state(tiny_config):
    return source.init_state(0, _port_cfg(tiny_config), "cpu")


def _reader(monkeypatch, reader):
    """"tensorstore": the orbax reader reads; "hidden": it cannot."""
    if reader == "hidden":
        monkeypatch.setitem(sys.modules, "tensorstore", None)
    else:
        pytest.importorskip("tensorstore")


def _jax_orbax_step(tiny_config, run_dir, step):
    """A JAX ``SourceState`` saved by the JAX package as an orbax
    directory (what its single-device runs write)."""
    import jax
    from mcmda_tpu.train import source as jsource
    from mcmda_tpu.utils import checkpoint as jckpt
    js = jsource.init_state(jax.random.key(3), tiny_config)
    jckpt.save(run_dir, js.replace(step=np.int32(step)), step=step,
               block=True)
    return js


@pytest.mark.parametrize("reader", ["tensorstore", "hidden"])
def test_newest_step_as_orbax_directory_raises(tiny_config, tmp_path,
                                               monkeypatch, reader):
    """A JAX run directory whose newest step is an orbax directory never
    resumes from an older step, nor from step 0: it resumes from that
    directory where the reader can read it, and raises where it cannot."""
    state = _state(tiny_config)
    checkpoint.save(str(tmp_path), state, step=10)
    js = _jax_orbax_step(tiny_config, str(tmp_path), 20)
    _reader(monkeypatch, reader)
    if reader == "tensorstore":
        assert checkpoint.latest_step(str(tmp_path)) == 20
        resumed, start = loop.maybe_resume(str(tmp_path), state)
        assert start == 20 and int(resumed.step) == 20
        assert np.array_equal(resumed.params["head"]["w"].numpy(),
                              np.asarray(js.params["head"]["w"]))
        assert tcli._resolve_ckpt(str(tmp_path)).endswith("step_00000020")
        os.remove(tmp_path / "step_00000010.npz")
        assert loop.maybe_resume(str(tmp_path), state)[1] == 20
        return
    for call in (lambda: checkpoint.latest_step(str(tmp_path)),
                 lambda: loop.maybe_resume(str(tmp_path), state),
                 lambda: tcli._resolve_ckpt(str(tmp_path))):
        with pytest.raises(ValueError, match=r"orbax.*numpy\.savez"):
            call()
    # with no npz at all it raises too, where it used to start from step 0
    os.remove(tmp_path / "step_00000010.npz")
    with pytest.raises(ValueError, match="step_00000020 is an orbax"):
        loop.maybe_resume(str(tmp_path), state)


@pytest.mark.parametrize("reader", ["tensorstore", "hidden"])
def test_older_orbax_directory_is_passed_over(tiny_config, tmp_path,
                                              monkeypatch, reader):
    state = _state(tiny_config)
    (tmp_path / "step_00000010").mkdir()
    checkpoint.save(str(tmp_path), state, step=10)  # both forms of step 10
    checkpoint.save(str(tmp_path), state, step=20)
    (tmp_path / "step_00000005").mkdir()
    _reader(monkeypatch, reader)
    assert checkpoint.latest_step(str(tmp_path)) == 20
    _, start = loop.maybe_resume(str(tmp_path), state)
    assert start == 20
    assert tcli._resolve_ckpt(str(tmp_path)).endswith("step_00000020")
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None
    # an in-flight save of a newer step is no checkpoint
    (tmp_path / "step_00000030.orbax-checkpoint-tmp-1").mkdir()
    assert checkpoint.latest_step(str(tmp_path)) == 20


def test_prune_leaves_orbax_directories(tiny_config, tmp_path):
    state = _state(tiny_config)
    (tmp_path / "step_00000001").mkdir()
    (tmp_path / "step_00000001" / "manifest").write_text("x")
    for s in (2, 3, 4):
        checkpoint.save(str(tmp_path), state, step=s)
    checkpoint.prune(str(tmp_path), keep=1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000004.npz"]
    assert os.listdir(tmp_path / "step_00000001") == ["manifest"]


# ----------------------------------------- F4: the logger's rank-0 gate
@pytest.mark.parametrize("rank", [0, 1])
def test_only_rank_zero_logs(tmp_path, monkeypatch, capsys, rank):
    """In an initialised process group only rank 0 writes the metrics
    file and the event file and echoes (``mcmda_tpu/utils/logging.py``)."""
    from mcmda_tpu_torch.utils import logging as mlog
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    logger = mlog.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"),
                                tensorboard_dir=str(tmp_path / "tb"))
    logger.log(3, {"loss": 1.5})
    logger.close()
    out = capsys.readouterr().out
    if rank == 0:
        assert "loss=1.5" in out
        assert sorted(os.listdir(tmp_path)) == ["m", "tb"]
    else:
        assert out == "" and os.listdir(tmp_path) == []


# ------------------------------------------------ F3: the one device helper
class _Reached(Exception):
    pass


def _spy(monkeypatch):
    calls = []

    def resolve(name="cuda", deterministic=False):
        calls.append((str(name), deterministic))
        raise _Reached

    monkeypatch.setattr(device_mod, "resolve", resolve)
    return calls


_CLI = {
    "train-source": (["train-source", "--synthetic", "--out", "o"], True),
    "adapt": (["adapt", "--synthetic", "--source-ckpt", "s", "--out", "o"],
              True),
    "evaluate": (["evaluate", "--synthetic", "--ckpt", "c"], False),
    "predict": (["predict", "--ckpt", "c", "--input", "i", "--out", "o"],
                False),
}


@pytest.mark.parametrize("cmd", list(_CLI))
def test_every_cli_command_reaches_the_device_helper(monkeypatch, cmd):
    calls = _spy(monkeypatch)
    argv, deterministic = _CLI[cmd]
    with pytest.raises(_Reached):
        tcli.main(argv + ["--device", "cuda:1"])
    assert calls == [("cuda:1", deterministic)]


_STATE = types.SimpleNamespace(params={"w": torch.zeros(1)},
                               bn_state={}, step=torch.zeros(()))
_API = {
    "train_source": (lambda cfg: api.train_source(cfg, [], [], device="cpu"),
                     True),
    "adapt": (lambda cfg: api.adapt(cfg, _STATE, [], [], []), True),
    "evaluate": (lambda cfg: api.evaluate(cfg, _STATE, [], []), False),
    "predict": (lambda cfg: api.predict(cfg, _STATE, []), False),
}


@pytest.mark.parametrize("fn", list(_API))
def test_every_api_function_reaches_the_device_helper(monkeypatch, fn):
    calls = _spy(monkeypatch)
    call, deterministic = _API[fn]
    with pytest.raises(_Reached):
        call(tcfg.ExperimentConfig())
    assert calls == [("cpu", deterministic)]


def test_device_helper_on_the_cpu_changes_no_flag():
    def flags():
        return (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.deterministic)

    before = flags()
    assert device_mod.resolve("cpu", deterministic=True) == \
        torch.device("cpu")
    assert flags() == before
    assert set(device_mod.settings()) == {"tf32", "cudnn_deterministic"}
    assert device_mod.settings()["cudnn_deterministic"] == before[2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_mod.resolve("cuda")
        assert flags() == before


def test_cli_cutoff_is_the_apis():
    """The CLI has no cutoff, sampler or step construction of its own."""
    import inspect
    text = inspect.getsource(tcli)
    for needle in ("1 << 30", "BatchSampler(", "make_train_step(",
                   "make_adapt_step(", "_latest_step", "allow_tf32",
                   "cudnn.deterministic"):
        assert needle not in text, needle
    assert api._ON_DEVICE_BYTES == 1 << 30
