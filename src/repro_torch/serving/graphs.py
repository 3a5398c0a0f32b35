"""Each serving step as one device program: the port's counterpart of
``jax.jit``.

The reference runs its decode horizon as one jitted ``lax.scan`` and its
chunk tick and slot step as jitted functions: one dispatch each.  Eager
PyTorch issues every op of a step from Python (~2600 for a llama2-7b
decode step), and the host's time per op, not the device, then sets the
step time.  A ``Program`` is one step over static buffers: ``body()``
reads its inputs from tensors that live as long as the program and writes
its outputs into others.  ``run()`` calls the body eagerly, or, with
``capture``, captures it once into a ``torch.cuda.CUDAGraph`` and replays
that graph on every later call: the whole step is then one launch from
the host.

* The horizon (``horizon_program``, ``run_horizon``): one live step of
  ``Model.decode_multi_paged`` (the decode step, argmax or sampling, the
  lane-state update) captured once and replayed ``horizon`` times, each
  replay's token and flag copied into row i of the (N, B) outputs on the
  device; the engine then reads them back once.  One graph serves every
  horizon.  Shards 2 and 4 (kernel 4 and ``combine_lse``) take the same
  path.
* The speculative round (``spec_program``, ``run_spec``): one live round of
  ``Model.decode_spec_paged`` (the drafts, from n-gram lookup or the
  drafter's ``spec_k`` decode steps and its backfill step, the verify
  pass, the rejection sampling, the lane state and history update)
  captured once and replayed ``horizon`` times, each replay's
  (K+1) candidates, flags and accepted count copied into row i of the
  (N, B, K+1) / (N, B) outputs on the device.
* The chunk tick (``chunk_program``): ``Model.prefill_chunk_paged`` at one
  (rows, chunk, table) shape, as the reference's jit is keyed by shape,
  and by the plan's shards (2 and 4: kernel 3's owned/LSE form per stripe
  and ``combine_lse``);
  with a model drafter, the engine runs the drafter's tick as a second
  program of the same shape over the draft pool.
* The slot step (``slot_program``): ``Model.decode_step`` over the slot
  pool and the next-token choice.

Prompt prefill stays eager: its buckets vary, and kernel 1 encodes its TMA
descriptors on the host at every call.

Capture: the first call of a program runs the body eagerly on a side
stream (the real step, and the warm-up that allocates the split kernels'
ticket buffers, cuBLAS's workspace and, on the slot pool, the state leaves
``decode_step`` recasts at its first step), then captures it on that
stream.  A capture that meets a host sync (``.item()``, a copy to the
host) raises with the program's name; there is no fallback to eager on
the card.  Before each replay the program compares the addresses of every
parameter and pool leaf with those it captured and recaptures when one
moved (a parameter or pool rebuilt under it); the engine drops its
programs on ``set_variant`` and ``set_shards``.

The kernel wrappers count their launches on the host, so a replay would
not count: a capture records each wrapper counter's advance (and puts the
counters back, since a capture launches nothing) and every replay adds it
again.  A captured run and an eager run of the same work therefore read
the same counts.
"""
from __future__ import annotations

import gc
import time

import torch

from repro_torch.models.transformer import Model, lane_keys


def _wrapper_counters() -> list:
    """``(wrapper, attribute)`` of every integer counter on the kernel
    wrappers (``launches``, ``tensor_core``, ``banded``, ...)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as i8
    from repro_torch.kernels import paged_decode_attention as pa
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import rwkv6_wkv as wkv
    wrappers = (fa.flash_attention, pa.paged_decode_attention,
                pa.paged_decode_attention_lse, ppa.paged_prefill_attention,
                ppa.paged_prefill_attention_lse, da.decode_attention,
                wkv.rwkv6_wkv, i8.int8_matmul)
    return [(fn, name) for fn in wrappers for name, v in vars(fn).items()
            if type(v) is int]


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


class Program:
    """One serving step over the static buffers ``bufs``.

    ``body()`` takes its inputs from ``bufs`` and writes its outputs into
    them; ``tensors()`` returns the (parameters, pool) it works on now.
    ``run()`` calls the body, eagerly unless ``capture`` (then the first
    call runs it on ``stream`` and captures it, later calls replay).
    ``captures`` counts captures, ``replays`` replays; ``capture_s`` holds
    each capture's (warm-up, record, end-and-instantiate) seconds."""

    def __init__(self, name: str, body, bufs: dict, tensors, *,
                 capture: bool, stream=None):
        self.name = name
        self.body = body
        self.bufs = bufs
        self.tensors = tensors
        self.capture = capture
        self.stream = stream
        self.graph = None
        self._deltas: list = []
        self._addresses: tuple = ()
        self.captures = 0
        self.replays = 0
        self.capture_s: list = []

    def _where(self) -> tuple:
        return tuple(t.data_ptr() for t in _leaves(self.tensors()))

    def run(self) -> None:
        if not self.capture:
            self.body()
            return
        if self.graph is not None and self._where() != self._addresses:
            self.graph = None            # a leaf moved under the graph
        if self.graph is None:
            self._capture()
            return
        self.graph.replay()
        for (fn, name), d in self._deltas:
            setattr(fn, name, getattr(fn, name) + d)
        self.replays += 1

    def _capture(self) -> None:
        main = torch.cuda.current_stream()
        side = self.stream
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.body()                  # the real step, and the warm-up
        counters = _wrapper_counters()
        before = [getattr(fn, name) for fn, name in counters]
        graph = torch.cuda.CUDAGraph()
        # a graph that dies during a capture (a program left to the cyclic
        # collector) frees its memory pool, which invalidates the capture:
        # no collection until the capture has ended
        collecting = gc.isenabled()
        gc.disable()
        t1 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, stream=side):
                self.body()
                t2 = time.perf_counter()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of the {self.name} "
                               f"failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            after = [getattr(fn, name) for fn, name in counters]
            for (fn, name), v in zip(counters, before):
                setattr(fn, name, v)
        t3 = time.perf_counter()
        main.wait_stream(side)
        self._deltas = [(c, a - b) for c, a, b in zip(counters, after, before)
                        if a != b]
        self._addresses = self._where()
        self.graph = graph
        self.captures += 1
        self.capture_s.append((t1 - t0, t2 - t1, t3 - t2))


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def _sampling_bufs(lanes: int, device) -> dict:
    return {"temps": _zeros(lanes, torch.float32, device),
            "top_ks": _zeros(lanes, torch.int32, device),
            "keys": _zeros((lanes, 2), torch.int64, device)}


def set_sampling(bufs: dict, temps, top_ks, seeds) -> None:
    """Fill a sampled program's buffers from host arrays of (B,) lane
    temperatures, top-k and int32 seeds (the keys are ``lane_keys``)."""
    bufs["temps"].copy_(torch.as_tensor(temps))
    bufs["top_ks"].copy_(torch.as_tensor(top_ks))
    bufs["keys"].copy_(lane_keys(torch.as_tensor(seeds)))


def _sampling_args(bufs: dict, sampled: bool) -> tuple:
    return (bufs["temps"], bufs["top_ks"], bufs["keys"]) if sampled else ()


def horizon_program(model: Model, tensors, lanes: int, width: int, *,
                    max_len: int, sampled: bool, capture: bool,
                    stream=None) -> Program:
    """One live step of the decode horizon over ``lanes`` lanes and block
    tables of ``width``: inputs ``tables``, ``eos`` and (sampled)
    ``temps``/``top_ks``/``keys``; lane state ``tokens``, ``positions``,
    ``active``, ``budgets``, advanced in place by every step; outputs
    ``nxt`` and ``emitted``."""
    dev = model.device
    i32 = torch.int32
    bufs = {"tokens": _zeros(lanes, i32, dev),
            "positions": _zeros(lanes, i32, dev),
            "active": _zeros(lanes, torch.bool, dev),
            "budgets": _zeros(lanes, i32, dev),
            "eos": _zeros(lanes, i32, dev),
            "tables": _zeros((lanes, width), i32, dev),
            "nxt": _zeros(lanes, i32, dev),
            "emitted": _zeros(lanes, torch.bool, dev)}
    if sampled:
        bufs.update(_sampling_bufs(lanes, dev))

    def body():
        params, cache = tensors()
        nxt, emitted, _ = model.horizon_step(
            params, cache, bufs["tokens"], bufs["positions"], bufs["active"],
            bufs["budgets"], bufs["tables"], bufs["eos"], max_len,
            *_sampling_args(bufs, sampled))
        bufs["nxt"].copy_(nxt)
        bufs["emitted"].copy_(emitted)

    kind = "sampled" if sampled else "greedy"
    return Program(f"decode horizon step ({kind}, {lanes} lanes)", body,
                   bufs, tensors, capture=capture, stream=stream)


def run_horizon(prog: Program, num_steps: int):
    """``num_steps`` runs of a horizon program, each step's ``nxt`` and
    ``emitted`` copied on the device into row i of ``(out_tokens (N, B),
    emitted (N, B))``, which it returns (nothing is read back)."""
    b = prog.bufs
    lanes = b["nxt"].shape[0]
    toks = torch.empty(num_steps, lanes, dtype=torch.int32,
                       device=b["nxt"].device)
    ems = torch.empty(num_steps, lanes, dtype=torch.bool,
                      device=b["nxt"].device)
    for i in range(num_steps):
        prog.run()
        toks[i].copy_(b["nxt"])
        ems[i].copy_(b["emitted"])
    return toks, ems


def spec_program(model: Model, drafter: Model | None, tensors, lanes: int,
                 width: int, hist_width: int, *, spec_k: int, max_len: int,
                 ngram: int, capture: bool, stream=None) -> Program:
    """One live round of speculative decode over ``lanes`` lanes, block
    tables of ``width`` and histories of ``hist_width``: ``tensors()``
    returns (params, pool, drafter params, draft pool), the drafter's
    None for n-gram drafts; inputs ``tables``, ``eos`` and ``temps``/
    ``top_ks``/``keys`` (greedy lanes at temperature 0, as the reference
    runs them: one program serves greedy and sampled batches); lane
    state ``tokens``, ``positions``,
    ``active``, ``budgets`` and ``hist``, advanced in place by every
    round; outputs ``cand`` (lanes, spec_k + 1), ``emit`` (the same,
    bool) and ``n_acc`` (lanes,)."""
    dev = model.device
    i32 = torch.int32
    bufs = {"tokens": _zeros(lanes, i32, dev),
            "positions": _zeros(lanes, i32, dev),
            "active": _zeros(lanes, torch.bool, dev),
            "budgets": _zeros(lanes, i32, dev),
            "eos": _zeros(lanes, i32, dev),
            "tables": _zeros((lanes, width), i32, dev),
            "hist": _zeros((lanes, hist_width), i32, dev),
            "cand": _zeros((lanes, spec_k + 1), i32, dev),
            "emit": _zeros((lanes, spec_k + 1), torch.bool, dev),
            "n_acc": _zeros(lanes, i32, dev),
            **_sampling_bufs(lanes, dev)}

    def body():
        params, cache, d_params, d_cache = tensors()
        cand, emit, n_acc = model.spec_round(
            drafter, params, cache, d_params, d_cache, bufs["hist"],
            bufs["tokens"], bufs["positions"], bufs["active"],
            bufs["budgets"], bufs["tables"], bufs["eos"], bufs["temps"],
            bufs["top_ks"], bufs["keys"], spec_k=spec_k, max_len=max_len,
            ngram=ngram)
        bufs["cand"].copy_(cand)
        bufs["emit"].copy_(emit)
        bufs["n_acc"].copy_(n_acc)

    source = drafter.cfg.name if drafter is not None else f"{ngram}-gram"
    return Program(f"speculative round ({lanes} lanes, spec_k="
                   f"{spec_k}, {source} drafts)", body, bufs, tensors,
                   capture=capture, stream=stream)


def run_spec(prog: Program, num_steps: int):
    """``num_steps`` runs of a speculative round program, each round's
    ``cand``, ``emit`` and ``n_acc`` copied on the device into row i of
    ``(out_tokens (N, B, K+1), emitted (N, B, K+1), n_acc (N, B))``,
    which it returns (nothing is read back)."""
    b = prog.bufs
    dev = b["cand"].device
    toks = torch.empty((num_steps,) + tuple(b["cand"].shape),
                       dtype=torch.int32, device=dev)
    ems = torch.empty_like(toks, dtype=torch.bool)
    accs = torch.empty((num_steps,) + tuple(b["n_acc"].shape),
                       dtype=torch.int32, device=dev)
    for i in range(num_steps):
        prog.run()
        toks[i].copy_(b["cand"])
        ems[i].copy_(b["emit"])
        accs[i].copy_(b["n_acc"])
    return toks, ems, accs


def chunk_program(model: Model, tensors, rows: int, chunk: int, width: int,
                  *, capture: bool, stream=None) -> Program:
    """One chunked-prefill tick at (rows, chunk) with tables of ``width``:
    inputs ``tokens``, ``starts``, ``lens``, ``tables``; output ``logits``
    (rows, V_pad) at each row's last valid chunk token."""
    dev = model.device
    i32 = torch.int32
    v_pad = model._unembed_w(tensors()[0]).shape[1]
    bufs = {"tokens": _zeros((rows, chunk), i32, dev),
            "starts": _zeros(rows, i32, dev),
            "lens": _zeros(rows, i32, dev),
            "tables": _zeros((rows, width), i32, dev),
            "logits": _zeros((rows, v_pad), model.plan.compute_dtype, dev)}

    def body():
        params, cache = tensors()
        logits, _ = model.prefill_chunk_paged(
            params, cache, bufs["tokens"], bufs["starts"], bufs["lens"],
            bufs["tables"])
        bufs["logits"].copy_(logits)

    return Program(f"chunk tick ({rows} rows x {chunk})", body, bufs,
                   tensors, capture=capture, stream=stream)


def slot_program(model: Model, tensors, slots: int, *, sampled: bool,
                 capture: bool, stream=None) -> Program:
    """One slot-pool decode step over ``slots`` slots and each slot's next
    token: inputs ``tokens``, ``positions`` and (sampled) ``temps``/
    ``top_ks``/``keys``; output ``nxt``."""
    dev = model.device
    i32 = torch.int32
    bufs = {"tokens": _zeros(slots, i32, dev),
            "positions": _zeros(slots, i32, dev),
            "nxt": _zeros(slots, i32, dev)}
    if sampled:
        bufs.update(_sampling_bufs(slots, dev))

    def body():
        params, cache = tensors()
        logits, _ = model.decode_step(params, cache, bufs["tokens"],
                                      bufs["positions"])
        bufs["nxt"].copy_(model.next_tokens(
            logits, bufs["positions"] + 1, *_sampling_args(bufs, sampled)))

    kind = "sampled" if sampled else "greedy"
    return Program(f"slot decode step ({kind}, {slots} slots)", body, bufs,
                   tensors, capture=capture, stream=stream)
