"""CUDA graphs: the port's counterpart of the JAX package's ``jax.jit``.

A graph is to the card what a compiled program is to the TPU: one host
call replays the whole recorded launch sequence (thousands of kernels), so
the host no longer sets the pace of the device.  Two kinds:

``GraphedSteps``, a train step replayed ``inner`` times per call
(``jax.jit(loop.scanned_step(step, inner), donate_argnums=(0,))``).  The
first call runs one train step eagerly on a side stream -- it is the
warm-up that capture needs (cuDNN and cuBLAS handles, the kernels'
shared-memory attributes, cached resize matrices) and it is also the call's
first real step -- then captures one step from its result and replays the
graph for the remaining steps.

- Inputs: the state lives in static buffers that the graph reads and, at
  the end of each replay, overwrites with the new state.  The batch is
  either the device-resident dataset, the same tensors at every call, or
  (``fed``) a batch from the host feed: the graph reads static batch
  buffers cloned from the first batch, and each later call copies its
  batch into them on the current stream (the feed has already made that
  stream wait for its copy), then replays.  A fed batch of another shape,
  dtype or device raises.
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

``GraphedCall``, a function of tensors (serving's volume, the selection
probe, the seed sweep's probes), captured once and replayed once per call;
``call`` picks it or the eager function.

Both capture under ``torch.cuda.set_sync_debug_mode("error")``, so a
function that waits on the device raises instead of being captured.
Each call opens host spans (``profiling.span``) around its parts: one
``graph.capture`` (the warm-up and the capture, at the first call and at
a recapture), else one ``graph.load`` (the inputs copied into the
graph's buffers), then one ``graph.replay`` (the replays and the output
copies); nothing inside a captured function opens one.  A
failed capture or replay raises; nothing falls back to eager execution.
A kernel wrapper counts its launches on the host, so the kernels'
``LAUNCHES`` count the warm-up and the launches that the capture records,
once each; a replay runs them on the device without the host.
"""

from __future__ import annotations

import time

import torch

from mcmda_tpu_torch.utils import prng, profiling, tree


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


def _sig(tensors):
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors]


def _check_sig(leaves, sig, what: str):
    """Raise unless ``leaves`` have the shapes, dtypes and devices
    ``sig``, one for one."""
    if _sig(leaves) != sig:
        raise ValueError(f"a CUDA graph was captured for a {what} of "
                         f"{sig}, not {_sig(leaves)}")


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
    one step (see the module docstring); ``fed``: the batch comes from the
    host feed, one step per call.  After the first call ``stats`` holds the
    capture's wall time and the graph pool's memory."""

    def __init__(self, step_fn, inner_steps: int, donate: bool = True,
                 fed: bool = False):
        if fed and int(inner_steps) != 1:
            raise ValueError("a step fed by the host takes one batch, so "
                             f"one step per call, not {inner_steps}")
        self.step_fn = step_fn
        self.inner = int(inner_steps)
        self.donate = donate
        self.fed = fed
        self.graph = None
        self.stats: dict = {}

    def __call__(self, state, batch, seed):
        first, metrics = 0, {}
        if self.graph is None:
            with profiling.span("graph.capture"):
                state, metrics = self._warm_up(
                    state, batch, prng.inner_key(seed, 0, self.inner))
            first = 1
        else:
            with profiling.span("graph.load"):
                if self.fed:
                    self._feed(batch)
                else:
                    self._check_batch(batch)
                self._load(state)
        if self.inner > first:
            with profiling.span("graph.replay"):
                for i in range(first, self.inner):
                    self.gen.manual_seed(prng.inner_key(seed, i,
                                                        self.inner))
                    self.graph.replay()
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
        if self.fed:  # the static batch buffers, read by the capture
            batch = tree.unflatten(batch, [t.clone()
                                           for t in tree.leaves(batch)])
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
        self._batch = tree.leaves(batch)
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
        if _ptrs(tree.leaves(batch)) != _ptrs(self._batch):
            raise ValueError("a CUDA graph step samples from the dataset it "
                             "was captured with: pass the same tensors at "
                             "every call")

    def _feed(self, batch):
        """Copy a fed batch into the static batch buffers."""
        leaves = tree.leaves(batch)
        _check_sig(leaves, _sig(self._batch), "batch")
        _copy_all(self._batch, leaves)

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



# ------------------------------------------------------------ graphed call
_POOL = None


def _pool():
    """The memory pool that every ``GraphedCall`` of the process captures
    into.  They replay one after another on one stream and copy their
    outputs out before they return, so no graph's memory is read after
    another graph's replay, and one pool serves them all."""
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    return _POOL


class GraphedCall:
    """``fn(*inputs) -> outputs`` (trees of tensors) on a CUDA graph,
    captured at the first call and replayed once per call.

    - Warm-up: before the capture, ``warm_up(*inputs)`` runs eagerly on a
      side stream: one batch of what ``fn`` runs, enough for what capture
      needs (see the module docstring), so that a one-volume call still
      replays the graph.
    - Inputs: a CUDA tensor that the first call passes is read by the graph
      where it lies (a donated train state: nothing is copied while the
      caller passes the same tensor); a host tensor gets a device buffer
      of the graph's own.  A later call copies each input into its own
      buffer, skipping a leaf that is that buffer; an input other than a
      tensor the graph reads in place makes the graph capture again on
      buffers of its own, since a copy into that tensor would overwrite
      the caller's.  Inputs of other shapes, dtypes or devices than the
      first call's raise.
    - Outputs: copied before the call returns (see ``_pool``).
    - ``stats``: the last capture's wall time and the pool's growth.
    """

    def __init__(self, fn, warm_up, device):
        self.fn, self.warm_up = fn, warm_up
        self.device = torch.device(device)
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.graph = None
        self.stats: dict = {}

    def __call__(self, *inputs):
        leaves = tree.leaves(inputs)
        if self.graph is None:
            self._sig = _sig(leaves)
            with profiling.span("graph.capture"):
                self._capture(inputs, leaves, borrow=True)
        else:
            _check_sig(leaves, self._sig, "call")
            if any(b and s.data_ptr() != t.data_ptr() for s, t, b
                   in zip(self._static, leaves, self._borrowed)):
                with profiling.span("graph.capture"):
                    self._capture(inputs, leaves, borrow=False)
            else:
                with profiling.span("graph.load"):
                    self._load(leaves)
        with profiling.span("graph.replay"):
            self.graph.replay()
            return tree.unflatten(self._out, [t.clone() for t in
                                              tree.leaves(self._out)])

    def _load(self, leaves):
        """Copy each input into the graph's own buffer (host inputs one by
        one, device inputs one multi-tensor copy per dtype)."""
        pairs = [(s, t) for s, t in zip(self._static, leaves)
                 if s.data_ptr() != t.data_ptr()]
        for s, t in pairs:
            if not t.is_cuda:
                s.copy_(t)
        _copy_all([s for s, t in pairs if t.is_cuda],
                  [t for _, t in pairs if t.is_cuda])

    def _capture(self, inputs, leaves, borrow: bool):
        """The static inputs (borrowed where ``borrow`` and on the device,
        else copies), the warm-up at the first capture, then the capture
        of ``fn`` on them into the shared pool."""
        if not all(t.device in (self.device, torch.device("cpu"))
                   for t in leaves):
            raise ValueError(f"a CUDA graph on {self.device} takes inputs on "
                             f"it or on the host, not {_sig(leaves)}")
        self.graph = self._out = None
        self._borrowed = [borrow and t.is_cuda for t in leaves]
        self._static = [t if b else t.to(self.device, copy=True)
                        for t, b in zip(leaves, self._borrowed)]
        static = tree.unflatten(inputs, self._static)
        current = torch.cuda.current_stream(self.device)
        if borrow:
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                self.warm_up(*static)
            current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=_pool(), stream=self.stream):
            reserved = torch.cuda.memory_reserved(self.device)
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._out = self.fn(*static)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize(self.device)
        self.graph = graph
        self.stats = {
            "capture_s": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved}


def call(fn, warm_up, device, graph: bool):
    """``fn`` as a ``GraphedCall`` where ``graph`` (``drivers.dispatch``
    says so), else ``fn`` itself, run eagerly with each host input moved to
    ``device`` first."""
    if graph:
        return GraphedCall(fn, warm_up, device)

    def eager(*inputs):
        return fn(*tree.unflatten(inputs, [t.to(device)
                                           for t in tree.leaves(inputs)]))
    return eager
