"""A train step captured as a CUDA graph and replayed ``inner`` times per
call: the port's counterpart of the JAX package's
``jax.jit(loop.scanned_step(step, inner), donate_argnums=(0,))``.

A graph is to the card what a compiled program is to the TPU: one host
call replays the whole recorded launch sequence of a step (thousands of
kernels), so the host no longer sets the pace of the device.  The first
call runs one train step eagerly on a side stream -- it is the warm-up that
capture needs (cuDNN and cuBLAS handles, the kernels' shared-memory
attributes, cached resize matrices) and it is also the call's first real
step -- then captures one step from its result and replays the graph for
the remaining steps.

- Inputs: the state lives in static buffers that the graph reads and, at
  the end of each replay, overwrites with the new state; the batch is the
  device-resident dataset, the same tensors at every call.
- Randomness: the step draws from one ``torch.Generator`` registered with
  the graph (``CUDAGraph.register_generator_state``); the host re-seeds it
  with ``prng.inner_key(seed, i, inner)`` before replay ``i``, so a replay
  draws what an eager step seeded with the same number draws.
- Donation (``run.donate``, default true): a call returns the static state
  itself, and the state passed to the next call is then overwritten, as
  under JAX's ``donate_argnums``.  Without donation each call returns fresh
  copies and leaves what it was given intact.
- Metrics: a call returns copies of the last step's, which the next replay
  does not overwrite (the JAX scan's ``x[-1]`` is a fresh array too).
- Host synchronisation: capture runs under
  ``torch.cuda.set_sync_debug_mode("error")``, so a step that waits on the
  device raises instead of being captured.  A failed capture or replay
  raises; nothing falls back to eager steps.
- Launch counters: a kernel wrapper counts its launches on the host, so
  the kernels' ``LAUNCHES`` count the warm-up step and the launches that
  the capture records, once each; a replay runs them on the device without
  the host.
"""

from __future__ import annotations

import time

import torch

from mcmda_tpu_torch.utils import prng, tree


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _copy_all(dst, src):
    """``d.copy_(s)`` for each pair, one multi-tensor copy per dtype (a
    mixed list would take one kernel per tensor)."""
    groups: dict = {}
    for d, s in zip(dst, src):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class GraphedSteps:
    """``step(state, batch, seed) -> (state, metrics)`` advancing
    ``inner_steps`` train steps of ``step_fn`` per call on a CUDA graph of
    one step (see the module docstring).  After the first call ``stats``
    holds the capture's wall time and the graph pool's memory."""

    def __init__(self, step_fn, inner_steps: int, donate: bool = True):
        self.step_fn = step_fn
        self.inner = int(inner_steps)
        self.donate = donate
        self.graph = None
        self.stats: dict = {}

    def __call__(self, state, batch, seed):
        first, metrics = 0, {}
        if self.graph is None:
            state, metrics = self._warm_up(
                state, batch, prng.inner_key(seed, 0, self.inner))
            first = 1
        else:
            self._check_batch(batch)
            self._load(state)
        for i in range(first, self.inner):
            self.gen.manual_seed(prng.inner_key(seed, i, self.inner))
            self.graph.replay()
        if self.inner > first:
            metrics = {k: v.clone() for k, v in self._metrics.items()}
        out = self._state if self.donate else tree.unflatten(
            self._state, [t.clone() for t in self._static])
        return out, metrics

    # ------------------------------------------------------------ capture
    def _warm_up(self, state, batch, seed):
        """The first call's first step, eagerly on a side stream, then the
        capture from its result."""
        leaves = tree.leaves(state)
        device = leaves[0].device
        on_gpu = [t.is_cuda for t in leaves + tree.leaves(batch)]
        if not all(on_gpu):
            raise ValueError("a CUDA graph step needs its state and its "
                             "batch on a CUDA device")
        current = torch.cuda.current_stream(device)
        self.stream = torch.cuda.Stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            new_state, metrics = self.step_fn(state, batch, seed)
        current.wait_stream(self.stream)
        for t in tree.leaves(new_state) + list(metrics.values()):
            t.record_stream(current)
        self._capture(new_state, set(_ptrs(leaves)), batch, device)
        return new_state, metrics

    def _capture(self, state, given, batch, device):
        """Static buffers from ``state`` (a copy of each leaf that the
        caller still holds, ``given``, or that repeats another), then one
        step captured on them, ending in the copy of the new state into
        the buffers."""
        static, seen = [], set()
        for t in tree.leaves(state):
            if t.data_ptr() in given or t.data_ptr() in seen:
                t = t.clone()
            seen.add(t.data_ptr())
            static.append(t)
        self._static = static
        self._state = tree.unflatten(state, static)
        self._batch = _ptrs(tree.leaves(batch))
        self.gen = torch.Generator(device=device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        self.gen.manual_seed(0)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            reserved = torch.cuda.memory_reserved(device)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out_state, self._metrics = self.step_fn(self._state, batch,
                                                        self.gen)
                self._write_back(tree.leaves(out_state))
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(device)
        self.graph = graph
        self.stats = {
            "capture_s": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(device) - reserved}
        print(f"[graph] captured one step in {self.stats['capture_s']:.2f} s; "
              f"{self.inner} per call; graph pool "
              f"{self.stats['pool_bytes'] / 2**20:.1f} MiB", flush=True)

    def _write_back(self, out):
        """Inside the capture: copy the step's new state into the static
        buffers (a leaf the step passed through is skipped; one that is
        another buffer is copied first, so no buffer is read after it is
        overwritten)."""
        if len(out) != len(self._static):
            raise ValueError(f"the step returned {len(out)} state tensors "
                             f"for {len(self._static)}")
        owned = set(_ptrs(self._static))
        dst, src = [], []
        for s, o in zip(self._static, out):
            if o.data_ptr() == s.data_ptr():
                continue
            dst.append(s)
            src.append(o.clone() if o.data_ptr() in owned else o)
        _copy_all(dst, src)

    # -------------------------------------------------------------- calls
    def _check_batch(self, batch):
        if _ptrs(tree.leaves(batch)) != self._batch:
            raise ValueError("a CUDA graph step samples from the dataset it "
                             "was captured with: pass the same tensors at "
                             "every call")

    def _load(self, state):
        """Copy ``state`` into the static buffers, leaf by leaf where it is
        not the static state already (a donated state is)."""
        leaves = tree.leaves(state)
        if len(leaves) != len(self._static):
            raise ValueError(f"state has {len(leaves)} tensors, the graph "
                             f"{len(self._static)}")
        pairs = [(s, t) for s, t in zip(self._static, leaves)
                 if s.data_ptr() != t.data_ptr()]
        _copy_all([s for s, _ in pairs], [t for _, t in pairs])
