"""A cell's run, by the kind of its traffic: set-up, the measured window,
the traced slice, and the check against the reference.

``train`` (T1 ``source`` or T2 ``adapt`` steps): the step and the feed
that the package's API builds for a device-resident dataset
(``api._source_step_feed`` / ``api._adapt_step_feed``: a CUDA graph of
one train step replayed ``inner`` times per call), driven by its training
loop (``loop.run``) in chunks of whole calls, from the step where the last
chunk stopped.  Set-up builds that one step object.  Its first call runs
a step eagerly and captures the graph: that call runs on a copy of the
starting state and is thrown away, so that every step the check reads is
a replay, as every step of the window is.  From the starting state, the
check's calls then take the traffic's ``check_calls`` steps each (one
replay, then two, whose seeds the call folds in per replay as the
window's calls do), keeping the losses and the state after each call;
the window then runs further calls of ``inner`` steps on the same object.
On the CPU, which runs no graph, each of those steps is a call of its own.

``serve``: back-to-back volumes through the API's ``predict``, one client
in a closed loop, each volume drawn from a pool made in set-up.

Every input is made here from the seed (``generator``); the program
receives only those inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
import time

import numpy as np
import torch

from benchmark import generator, judge, roofline
from benchmark.reference import pnp_adanet as ref
from benchmark.reference import train as ref_train
from benchmark.trace import marker, record

# generator streams of a run's inputs
_SOURCE_W, _CRITIC_W, _SRC_DATA, _TGT_DATA, _POOL = 1, 2, 3, 4, 5


def experiment(conf: dict, seed: int):
    """The package's ``ExperimentConfig`` of a configuration file, with the
    run's seed."""
    from mcmda_tpu_torch.config import ExperimentConfig
    cfg = ExperimentConfig.from_json(json.dumps(conf["experiment"]))
    return dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                            seed=seed))


def _norms(a: dict, b: dict | None = None) -> dict:
    """{leaf: ||a - b||} (or ||a||) as floats, read back in one copy."""
    keys = sorted(a)
    v = torch.stack([torch.linalg.vector_norm(
        (a[k] - b[k]) if b is not None else a[k]).float() for k in keys])
    return dict(zip((".".join(k) for k in keys), v.cpu().tolist()))


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def slices(gen, n: int, depth: int, size: int, domain: str, device,
           context: int):
    """(context-stacked slices [n*depth,H,W,ctx] f32, labels int32)."""
    vols, labs = generator.phantoms(gen, n, depth, size, domain, device)
    images = generator.stack_context(vols, context)
    return images, labs.reshape(-1, size, size).to(torch.int32)


def graphed(device) -> bool:
    """Whether the program runs a train step on a CUDA graph on
    ``device`` (``drivers.dispatch`` on one device): the check's calls
    then take ``check_calls`` steps each, else one step a call."""
    return torch.device(device).type == "cuda"


class TrainCell:
    kind = "train"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.cfg = experiment(conf, seed)
        self.adapt = traffic["step"] == "adapt"
        self.batch = self.cfg.data.batch_size
        self.graphed = graphed(self.device)
        plan = list(traffic["check_calls"])
        self.plan = plan if self.graphed else [1] * sum(plan)

    # ----------------------------------------------------------- inputs
    def _data(self):
        t, d = self.traffic, self.cfg.data
        dom = self.conf["domains"]
        mk = lambda stream, n, domain: slices(  # noqa: E731
            generator.generator(self.seed, stream, self.device), n,
            t["depth"], d.slice_size, domain, self.device, d.context_slices)
        if not self.adapt:
            return {"source": mk(_SRC_DATA, t["volumes"], dom["source"])}
        return {"source": mk(_SRC_DATA, t["src_volumes"], dom["source"]),
                "target": mk(_TGT_DATA, t["tgt_volumes"], dom["target"])}

    def _weights(self):
        params, bn = generator.segmenter_init(self.seed, _SOURCE_W,
                                              self.device)
        critic = (generator.critic_init(self.seed, _CRITIC_W, self.device)
                  if self.adapt else None)
        return params, bn, critic

    @property
    def run_seed(self) -> int:
        # the API's loop seeds: train_source's run seed, adapt's main phase
        return self.cfg.run.seed + (6 if self.adapt else 0)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from mcmda_tpu_torch import api
        from mcmda_tpu_torch.data.volumes import SliceDataset
        from mcmda_tpu_torch.train import adapt as adapt_mod
        from mcmda_tpu_torch.train import source as source_mod
        from mcmda_tpu_torch.utils import device as device_mod
        from mcmda_tpu_torch.utils import tree

        cfg = self.cfg
        device_mod.resolve(self.device, deterministic=True)

        def dataset(images, labels):
            n = images.shape[0]
            ds = SliceDataset(
                images=images.cpu().numpy(),
                labels=None if labels is None else labels.cpu().numpy(),
                volume_ids=np.arange(n, dtype=np.int32) // self.traffic[
                    "depth"],
                slice_ids=np.arange(n, dtype=np.int32) % self.traffic[
                    "depth"])
            return ds

        data = self._data()
        params, bn, critic = self._weights()
        self.start = {"params": {k: v.clone() for k, v in params.items()}}
        nest = ref.nest
        if not self.adapt:
            ds = dataset(*data["source"])
            del data
            _free(self.device)
            self.state = source_mod.SourceState(
                params=nest(params), bn_state=nest(bn),
                opt_state=source_mod.make_tx(cfg).init(nest(params)),
                step=torch.zeros((), dtype=torch.int32, device=self.device))
            self.step, self.feed, on_device, self.inner = \
                api._source_step_feed(cfg, ds, 0, self.device,
                                      cfg.source.steps)
        else:
            src_ds = dataset(data["source"][0], None)
            tgt_ds = dataset(data["target"][0], None)
            del data
            _free(self.device)
            state = adapt_mod.init_state(cfg.run.seed + 2, cfg, nest(params),
                                         nest(bn))
            _, tx_d = adapt_mod.make_txs(cfg)
            self.state = dataclasses.replace(
                state, critic_params=nest(critic),
                opt_d_state=tx_d.init(nest(critic)))
            self.start = {"dam": {k: v for k, v in self.start[
                "params"].items() if k[0] in self._dam_stages()},
                "critic": {k: v.clone() for k, v in critic.items()}}
            n_adapt = cfg.adapt.steps
            mk_step, make_feed, on_device, self.inner = api._adapt_step_feed(
                cfg, src_ds, tgt_ds, 0, self.device, cfg.adapt.pretrain_steps,
                n_adapt, api._select_every(cfg, n_adapt))
            self.step, self.feed = mk_step(), make_feed()
        if not on_device:
            raise RuntimeError("the traffic's dataset left the device-"
                               "resident feed: the cut moved")
        graphed = hasattr(self.step, "graph")
        if graphed != self.graphed:
            raise RuntimeError(f"the step runs {'on' if graphed else 'off'} "
                               f"a CUDA graph on {self.device}")
        if self.inner != 1 and not graphed:
            raise RuntimeError("the step object does not expose its steps "
                               "per call, so the check cannot drive its "
                               "steps in calls of its own")
        if graphed:   # the eager step and the capture, thrown away
            start = self.state
            self.state = tree.unflatten(start, [t.clone() for t in
                                                tree.leaves(start)])
            self._drive(0, 1)
            self.state = start
        self.prog = {"losses": [], "change": [], "mu": None}
        for call, k in enumerate(self.plan):
            self._snapshot(self._drive(call, k))
        if graphed:
            self.step.inner = self.inner
        self.start = None
        self.calls = len(self.plan)

    def _drive(self, call: int, k: int) -> dict:
        """One check call of ``k`` steps (``step.inner`` set to it)."""
        if self.graphed:
            self.step.inner = k
        return self._call(call, k)

    def _dam_stages(self):
        names = []
        for name, *_ in ref.STAGES:
            names.append(name)
            if name == self.cfg.adapt.plug_depth:
                return names
        raise ValueError(self.cfg.adapt.plug_depth)

    def _trees(self):
        """({tree: flat params}, {tree: flat Adam first moment})."""
        s = self.state
        if not self.adapt:
            return ({"params": ref.flat(s.params)},
                    {"params": ref.flat(s.opt_state[0].mu)})
        return ({"dam": ref.flat(s.dam_params),
                 "critic": ref.flat(s.critic_params)},
                {"dam": ref.flat(s.opt_g_state[0].mu),
                 "critic": ref.flat(s.opt_d_state[0].mu)})

    def _snapshot(self, metrics: dict) -> None:
        trees, mu = self._trees()
        keys = ("d_loss", "g_loss") if self.adapt else ("loss", "xent",
                                                        "dice_loss")
        self.prog["losses"].append({k: metrics[k] for k in keys})
        self.prog["change"].append({t: _norms(trees[t], self.start[t])
                                    for t in trees})
        if self.prog["mu"] is None:
            self.prog["mu"] = {t: _norms(mu[t]) for t in mu}

    def _call(self, call: int | None = None, k: int | None = None) -> dict:
        """One call of the step object through the loop: ``k`` train steps
        (the graph's ``inner``), the call index ``call`` (the next)."""
        from mcmda_tpu_torch.train import loop
        k = k or self.inner
        if call is None:
            call, self.calls = self.calls, self.calls + 1
        self.state, metrics = loop.run(
            self.step, self.state, self.feed, (call + 1) * k,
            seed=self.run_seed, log_every=self.cfg.run.log_every,
            start_step=call * k, inner_steps=k)
        if not all(math.isfinite(v) for v in metrics.values()):
            self.failed_steps += k
        return metrics

    failed_steps = 0

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        calls0 = self.calls
        t0 = self.window_start = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call()
        elapsed = time.perf_counter() - t0
        self.attempted = (self.calls - calls0) * self.inner
        return {"train_slices_per_s": self.attempted * self.batch / elapsed}

    def traced(self):
        n = self.traffic["trace_calls"]

        def calls():
            with marker():
                for _ in range(n):
                    self._call()
                torch.cuda.synchronize()
        return Reading(self.kind, record(calls), n * self.inner, self.conf,
                       self.cfg, self.traffic)

    def release(self) -> None:
        self.step = self.feed = self.state = None
        _free(self.device)

    # ------------------------------------------------------------- check
    FAULTS = ("half_batch", "unchanged", "one_seed")

    def reference(self, rnd=None, fault=None) -> dict:
        """The reference's readings at the check's calls, from the same
        seed; ``rnd`` rounds its products (a control).  ``fault``, one of
        ``FAULTS``, plants a fault in it: half of each batch left out, a
        step that returns its state unchanged, or every step of a call
        drawn from the seed of its first."""
        if fault is not None and fault not in self.FAULTS:
            raise ValueError(f"no fault {fault!r}")
        cfg = self.cfg
        ref.set_exact()
        data = self._data()
        params, bn, critic = self._weights()
        d = cfg.data
        dcfg = {"batch_size": d.batch_size, "num_classes": d.num_classes,
                "rotate_degrees": d.rotate_degrees,
                "zoom_range": d.zoom_range, "shift_pixels": d.shift_pixels}
        if fault == "half_batch":
            dcfg["keep"] = d.batch_size // 2
        out = {"losses": [], "change": [], "mu": None, "first_grads": None}
        if not self.adapt:
            images, labels = data["source"]
            arrays = {"images": images, "labels": labels}
            s = cfg.source
            adam = ref.Adam(s.lr, s.beta1, s.beta2, s.steps, s.lr_schedule)
            st = {"params": params, "bn": ref.nest(bn),
                  "opt": adam.init(params)}
            start = {"params": dict(params)}
        else:
            a = cfg.adapt
            arrays = {"src": data["source"][0], "tgt": data["target"][0]}
            total = a.pretrain_steps + a.steps
            adam_g = ref.Adam(a.lr_g, a.beta1, a.beta2, total, a.lr_schedule)
            adam_d = ref.Adam(a.lr_d, a.beta1, a.beta2, total, a.lr_schedule)
            dam = {kk: v.clone() for kk, v in params.items()
                   if kk[0] in self._dam_stages()}
            st = {"src_params": ref.nest(params), "src_bn": ref.nest(bn),
                  "tgt_bn": ref.nest({kk: v.clone() for kk, v in bn.items()}),
                  "dam": dam, "critic": critic, "adam_g": adam_g,
                  "adam_d": adam_d, "opt_g": adam_g.init(dam),
                  "opt_d": adam_d.init(critic)}
            start = {"dam": dict(dam), "critic": dict(critic)}
            adapt_cfg = {"plug_depth": a.plug_depth,
                         "d_acc_cap": a.d_acc_cap}
        keys = ("d_loss", "g_loss") if self.adapt else ("loss", "xent",
                                                        "dice_loss")
        for call, k in enumerate(self.plan):
            for i in range(k):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(ref.inner_seed(
                    self.run_seed, call, 0 if fault == "one_seed" else i, k))
                if not self.adapt:
                    p, b, o, m, grads = ref_train.source_step(
                        st["params"], st["bn"], st["opt"], adam, arrays,
                        gen, dcfg, rnd)
                    if fault != "unchanged":
                        st = {"params": p, "bn": b, "opt": o}
                    grads = {"params": grads}
                else:
                    new, m, (gd, gg) = ref_train.adapt_step(
                        st, arrays, gen, dcfg, adapt_cfg, rnd)
                    if fault != "unchanged":
                        st = new
                    grads = {"dam": gg, "critic": gd}
                if out["first_grads"] is None:
                    out["first_grads"] = {t: _norms(g)
                                          for t, g in grads.items()}
            out["losses"].append({kk: float(m[kk]) for kk in keys})
            trees = ({"dam": st["dam"], "critic": st["critic"]}
                     if self.adapt else {"params": st["params"]})
            out["change"].append({t: _norms(trees[t], start[t])
                                  for t in trees})
            if out["mu"] is None:
                mus = ({"dam": st["opt_g"]["mu"], "critic": st["opt_d"]["mu"]}
                       if self.adapt else {"params": st["opt"]["mu"]})
                out["mu"] = {t: _norms(v) for t, v in mus.items()}
        return out

    def readings(self, ref_side: dict, prog_side: dict | None = None):
        """The check's numbers of ``prog_side`` (the program's by
        default) against the reference's side."""
        return judge.train_readings(
            prog_side or self.prog, ref_side,
            ("d_loss",) if self.adapt else None)

    def check(self):
        """-> (readings, attempted, failed)."""
        side = self.reference()
        return self.readings(side), self.attempted, self.failed_steps


class ServeCell:
    kind = "serve"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.seed = conf, traffic, seed
        self.device = torch.device(device)
        self.cfg = experiment(conf, seed)
        c = self.cfg
        self.batch = c.data.batch_size
        self.tta = c.run.eval_tta == "flip"
        self.dtype = torch.bfloat16 if c.run.eval_bf16 else torch.float32

    def _state_leaves(self):
        """(frozen params, DAM params, BN state), flat: drawn from the
        seed, the BN statistics then those of the first pool volume's
        middle slices through the adapted net (a trained net's running
        statistics follow its data; drawn ones leave the output nearly
        the same class everywhere)."""
        ref.set_exact()
        plug = self.cfg.adapt.plug_depth
        params, dam, bn = generator.serving_state(self.seed, plug,
                                                  self.device)
        vol = self._pool()[0]
        mid = vol.shape[0] // 2
        x = generator.stack_context(vol[None], self.cfg.data.context_slices)
        x = x[max(0, mid - self.batch // 2):][:self.batch]
        with torch.no_grad():
            new_bn = ref.forward(ref.nest(params), ref.nest(bn), x,
                                 train=True, dam=ref.nest(dam),
                                 plug_depth=plug, momentum=0.0)[3]
        return params, dam, ref.flat(new_bn)

    def _pool(self):
        t, d = self.traffic, self.cfg.data
        vols, _ = generator.phantoms(
            generator.generator(self.seed, _POOL, self.device), t["pool"],
            t["depth"], d.slice_size, self.conf["domains"]["target"],
            self.device)
        return vols

    def setup(self) -> None:
        from mcmda_tpu_torch import api
        from mcmda_tpu_torch.train import adapt as adapt_mod
        params, dam, bn = self._state_leaves()
        nest = ref.nest
        self.state = adapt_mod.AdaptState(
            src_params=nest(params), src_bn=nest(bn), dam_params=nest(dam),
            tgt_bn=nest(bn), critic_params=None, opt_g_state=None,
            opt_d_state=None,
            step=torch.zeros((), dtype=torch.int32, device=self.device))
        self.pool = [v.cpu().numpy() for v in self._pool()]
        rng = np.random.default_rng(ref.fold_in(self.seed, _POOL))
        self.order = iter(rng.integers(0, len(self.pool), size=1 << 20))
        self.served = []   # (pool index, mask) of every request judged
        self.predict = api.predict

    def _stream(self, seconds=None, count=None, trace=False):
        """``predict``'s volumes: a first one (the call captures its graph
        on it), then volumes until ``seconds`` have passed or ``count``
        are done, each timed from the call for it to its mask on the host
        (the next request).  Under ``trace`` the marker spans them."""
        self.lat, self.idx = [], []
        i = int(next(self.order))
        self.idx.append(i)
        yield self.pool[i]
        mark = marker() if trace else None
        if mark is not None:
            torch.cuda.synchronize()
            mark.__enter__()
        t = self.window_start = time.perf_counter()
        while (seconds is not None and t - self.window_start < seconds) or \
                (count is not None and len(self.lat) < count):
            i = int(next(self.order))
            self.idx.append(i)
            yield self.pool[i]
            now = time.perf_counter()
            self.lat.append(now - t)
            t = now
        self.window_end = t
        if mark is not None:
            mark.__exit__(None, None, None)

    def _predict(self, stream) -> None:
        masks = self.predict(self.cfg, self.state, stream)
        self.served += list(zip(self.idx, masks))

    def window(self, seconds: float) -> dict:
        self._predict(self._stream(seconds=seconds))
        elapsed = self.window_end - self.window_start
        depth = self.traffic["depth"]
        self.attempted = len(self.lat)
        p95 = (statistics.quantiles(self.lat, n=100, method="inclusive")[94]
               if len(self.lat) > 1 else self.lat[0])
        return {"serve_slices_per_s": len(self.lat) * depth / elapsed,
                "volume_ms_p95": 1000 * p95}

    def traced(self):
        n = self.traffic["trace_volumes"]
        tr = record(lambda: self._predict(self._stream(count=n, trace=True)))
        return Reading(self.kind, tr, n, self.conf, self.cfg, self.traffic)

    def release(self) -> None:
        _free(self.device)

    # ------------------------------------------------------------- check
    def reference_probs(self, rnd=None):
        """[pool, S, H, W, classes] from the reference, in float32 (the
        configuration serves in bf16; the reference is the exact answer
        that the served labels are judged against)."""
        ref.set_exact()
        params, dam, bn = self._state_leaves()
        c = self.cfg
        vols = self._pool()
        return torch.stack([ref.serve_volume_probs(
            ref.nest(params), ref.nest(bn), v, dtype=torch.float32,
            batch=self.batch, context=c.data.context_slices, tta=self.tta,
            dam=ref.nest(dam), plug_depth=c.adapt.plug_depth, rnd=rnd)
            for v in vols])

    def serve_readings(self, probs, served) -> tuple[dict, int]:
        """(readings, answers that are malformed) of the masks ``served``
        against the reference's ``probs``: per pixel, how far the
        probability of the served class lies below the best.
        ``slice_gap``: the worst slice's mean of it; ``pixel_gap``: the
        widest pixel's; ``miss_share``: the share of pixels served
        another class than the reference's best."""
        best = probs.max(-1).values
        shape = tuple(probs.shape[1:4])
        slice_gap = pixel_gap = misses = pixels = 0.0
        bad = 0
        for i, mask in served:
            if mask.shape != shape or not np.issubdtype(mask.dtype,
                                                        np.integer):
                bad += 1
                continue
            m = torch.from_numpy(mask.astype(np.int64)).to(probs.device)
            if int(m.min()) < 0 or int(m.max()) >= probs.shape[-1]:
                bad += 1
                continue
            g = best[i] - probs[i].gather(-1, m[..., None])[..., 0]
            slice_gap = max(slice_gap, float(g.mean((1, 2)).max()))
            pixel_gap = max(pixel_gap, float(g.max()))
            misses += float((g > 0).sum())
            pixels += g.numel()
        return {"slice_gap": slice_gap, "pixel_gap": pixel_gap,
                "miss_share": misses / max(pixels, 1)}, bad

    def check(self):
        readings, bad = self.serve_readings(self.reference_probs(),
                                            self.served)
        return readings, self.attempted, bad

    def control_masks(self, rnd):
        """The control's answers: the reference's argmax under ``rnd``,
        one per pool volume."""
        probs = self.reference_probs(rnd)
        return [(i, probs[i].argmax(-1).to(torch.uint8).cpu().numpy())
                for i in range(probs.shape[0])]


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the traced slice, the units of work
    in it (train steps or volumes), and the cell that ran: its
    configuration file (``conf``), the package's config of it (``cfg``)
    and its traffic mix (``traffic``), from which a reader works out the
    shapes, call sites and FLOPs of its layer."""

    kind: str
    trace: object
    units: int
    conf: dict
    cfg: object
    traffic: dict

    peaks = roofline.PEAKS

    @property
    def batch(self) -> int:
        return self.cfg.data.batch_size

    @property
    def size(self) -> int:
        return self.cfg.data.slice_size

    @property
    def serve_dtype(self) -> str:
        return "bfloat16" if self.cfg.run.eval_bf16 else "float32"

    @property
    def forward_batch(self) -> int:
        """A serving forward's batch: twice the batch under flip TTA."""
        return self.batch * (2 if self.cfg.run.eval_tta == "flip" else 1)


KINDS = {"train": TrainCell, "serve": ServeCell}


def make(conf: dict, traffic: dict, seed: int, device):
    return KINDS[traffic["kind"]](conf, traffic, seed, device)
