"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain PyTorch
version.

The kernel (``csrc/rwkv6_wkv.cu``) replaces the Pallas TPU kernel
``repro/kernels/rwkv6_wkv.py::rwkv6_wkv``.  Per (batch, head) a D x D f32
state S is carried over time::

    y_t = r_t . (S + (u * k_t) v_t^T);   S <- diag(w_t) S + k_t v_t^T

r/k/v (B, T, H, D) in f32 or bf16, w (B, T, H, D) f32 decay in (0, 1),
u (H, D) f32, s0 (B, H, D, D) f32 or None for a zero state -> y (B, T, H, D)
in r's dtype and the final state (B, H, D, D) f32.  Any T (the Pallas
kernel asserts ``T % block_t == 0``); any D % 16 == 0 up to 128.  With
``s_out`` the final state is written there, and ``s_out`` may be ``s0``:
the slot pool's decode updates its state in place.  The kernel splits the
state's columns over CTAs and each column's rows over lanes of a warp, as
``wkv_plan`` says from the shapes; y's sums have one order whatever the
split (``rwkv6_wkv_split_ref``), so a call of T steps and T calls of one
give the same bits.

The plain version ports the oracle ``kernels/ref.py::rwkv6_wkv_ref``: a
loop over time in f32, y cast to r's dtype once.  The reference model's
``_wkv_chunk`` (``models/ssm.py:214``) does the same arithmetic, chunked
only by a carried state, so one plain version serves both parity targets.

Training adds two calls (``ops.WkvFn`` ties them together).
``rwkv6_wkv_train`` is the same launch, the same stepping body and the
same bits for y, that also writes the state S_t before every step t that
is a multiple of C = ``wkv_chunk(D)`` (32 at D = 64): checkpoints (B, H,
ceil(T / C), D, D) f32, the first one s0 (or zeros).  ``rwkv6_wkv_bwd``
launches kernel 7's backward (``csrc/rwkv6_wkv_bwd.cu``), which walks
time backwards chunk by chunk, recomputing each chunk's states from its
checkpoint on chip (never recovering S_{t-1} from S_t by dividing by w,
which underflows toward 0), the rows of the state split over a cluster
of P CTAs (``wkv_bwd_plan``): with G_t = dL/dS_t (G_T = dS_T, or 0),

    dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
    dk_t = G_t v_t + r_t * u (v_t . dy_t)
    dv_t = G_t^T k_t + c_t dy_t,           c_t = sum_i r_i u_i k_i
    dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]
    du += r_t * k_t (v_t . dy_t)            (per (b, h), then summed over b)
    G_{t-1} = diag(w_t) G_t + r_t dy_t^T,   ds0 = G_0.

The reference has no Pallas backward: its gradient is XLA autodiff of
``_wkv_chunk``.  ``rwkv6_wkv_bwd_ref`` is the same reverse loop in f32 in
plain torch, for the CPU; ``rwkv6_wkv_bwd_split_ref`` is that loop with
dv summed as the kernel's cluster sums it, per group of rows (with the
group's part of c_t) and then in rank order (for the tests).
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
# lanes a column of S splits over, per head dim: 16 rows a lane at
# rwkv6-3b's D = 64 (flash_turns.py --sweep), about 8 elsewhere (not
# swept).  The kernel instantiates these, and Q = 2, 8 and 16 at D = 64
# for the sweep
_LANES = {16: 2, 32: 4, 48: 4, 64: 4, 80: 8, 96: 8, 112: 8, 128: 8}
_CTA_LANES = 128        # stepping lanes a CTA the plan starts from
# rows of a block of S's column (csrc row_block) and partials of y_j's sum
# (csrc parts: the largest power of two up to 16 dividing the blocks)
_ROW_BLOCK = {d: 2 if d in (80, 112) else 4 for d in HEAD_DIMS}
_PARTS = {16: 4, 32: 8, 48: 4, 64: 16, 80: 8, 96: 8, 112: 8, 128: 16}


@functools.lru_cache(maxsize=256)
def wkv_plan(B: int, H: int, D: int) -> tuple[int, int]:
    """``(JC, Q)`` of a launch over B * H heads of D, from shapes alone: Q
    lanes a column of S (``_LANES``), JC columns a CTA, the largest power
    of two dividing D with JC * Q <= 128 stepping lanes, halved (down to
    one warp) while the grid of B * H * (D / JC) CTAs would leave more
    than half the card's SMs idle.  Each CTA's producer warp copies its
    heads' whole rows, so wide CTAs that leave some SMs idle beat narrow
    ones that fill them: at rwkv6-3b's prefill (40 heads) 80 CTAs of 32
    columns beat 160 of 16.  A call of any length takes the same plan,
    and Q changes which lanes add y's partials, never the order they are
    added in, so the plan changes no bits either way."""
    q = _LANES[D]
    jc = 1
    while 2 * jc * q <= _CTA_LANES and D % (2 * jc) == 0:
        jc *= 2
    while jc * q > 32 and B * H * (D // jc) < build.SMS // 2:
        jc //= 2
    return jc, q


def wkv_chunk(D: int) -> int:
    """C, the steps between two of the training form's checkpoints: the
    largest power of two up to 2048 / D (32 at rwkv6-3b's D = 64), so the
    backward's two staged chunks of v and dy take 16 KB of shared memory
    in bf16 at every head dim (two of its CTAs an SM at D = 64)."""
    c = 1
    while 2 * c * D <= 2048:
        c *= 2
    return c


def _wkv_loop(r, k, v, w, u, s0, chunk: int | None):
    """The oracle's loop: (y f32, final state, checkpoints or None); with
    ``chunk`` the state before every step t % chunk == 0 is kept."""
    B, T, H, D = r.shape
    s = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    uf = u.float()[None]
    ys, ck = [], []
    for t in range(T):
        if chunk is not None and t % chunk == 0:
            ck.append(s)
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        at = kt[..., :, None] * vt[..., None, :]
        bonus = (uf * kt)[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + bonus))
        s = wt[..., :, None] * s + at
    y = torch.stack(ys, dim=1) if ys else r.new_zeros(r.shape, dtype=torch.float32)
    if chunk is None:
        return y, s, None
    ck = torch.stack(ck, dim=2) if ck else s.new_zeros(B, H, 0, D, D)
    return y, s, ck


def rwkv6_wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  s0: torch.Tensor | None = None, *,
                  s_out: torch.Tensor | None = None):
    """Plain WKV (port of ``kernels/ref.py::rwkv6_wkv_ref``).  r/k/v/w
    (B, T, H, D); u (H, D); s0 (B, H, D, D) or None (zeros).  Returns
    (y (B, T, H, D) in r's dtype, s (B, H, D, D) f32); s is copied into
    ``s_out`` when given, as the kernel writes it there."""
    y, s, _ = _wkv_loop(r, k, v, w, u, s0, None)
    return y.to(r.dtype), (s if s_out is None else s_out.copy_(s))


def rwkv6_wkv_train_ref(r, k, v, w, u, s0=None):
    """Plain training form: ``rwkv6_wkv_ref``'s (y, s) and the checkpoints
    (B, H, ceil(T / C), D, D) f32, the state before steps 0, C, 2C, ...
    (C = ``wkv_chunk(D)``)."""
    rwkv6_wkv_train_ref.calls += 1
    y, s, ck = _wkv_loop(r, k, v, w, u, s0, wkv_chunk(r.shape[-1]))
    return y.to(r.dtype), s, ck


def _wkv_bwd_loop(r, k, v, w, u, ckpt, dy, ds, groups):
    """The reverse loop of ``rwkv6_wkv_bwd_ref``; with ``groups`` dv is
    summed as the kernel's cluster sums it: per group of D / groups rows,
    G_t^T k_t over the group's rows plus the group's part of c_t times
    dy_t, the groups' partials then added in order."""
    B, T, H, D = r.shape
    C = wkv_chunk(D)
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()[None]
    G = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device) \
        if ds is None else ds.float().clone()
    dr, dk, dv, dw = (torch.empty(B, T, H, D, dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros(B, H, D, dtype=torch.float32, device=r.device)
    for n in reversed(range(ckpt.shape[2])):
        t0, t1 = n * C, min(T, (n + 1) * C)
        states = [ckpt[:, :, n].float()]
        for t in range(t0, t1 - 1):
            states.append(wf[:, t, ..., :, None] * states[-1]
                          + kf[:, t, ..., :, None] * vf[:, t, ..., None, :])
        for t in reversed(range(t0, t1)):
            S = states[t - t0]
            rt, kt, vt, wt, dyt = (a[:, t] for a in (rf, kf, vf, wf, dyf))
            vdy = (vt * dyt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", S, dyt) + uf * kt * vdy
            dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uf * vdy
            if groups is None:
                c = (rt * uf * kt).sum(-1, keepdim=True)
                dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + c * dyt
            else:
                gk = (G * kt[..., :, None]).unflatten(
                    -2, (groups, D // groups)).sum(-2)       # (B, H, P, D)
                cp = (rt * uf * kt).unflatten(-1, (groups, D // groups)) \
                    .sum(-1)                                 # (B, H, P)
                parts = gk + cp[..., None] * dyt[..., None, :]
                acc = parts[..., 0, :]
                for p in range(1, groups):
                    acc = acc + parts[..., p, :]
                dv[:, t] = acc
            dw[:, t] = (G * S).sum(-1)
            du += rt * kt * vdy
            G = wt[..., :, None] * G + rt[..., :, None] * dyt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw,
            du.sum(0), G)


def rwkv6_wkv_bwd_ref(r, k, v, w, u, ckpt, dy, ds=None):
    """Plain backward of the WKV recurrence, the kernel's reverse loop in
    f32 (the module docstring's equations): chunk by chunk from the last,
    the chunk's states recomputed from its checkpoint, then its steps
    walked backwards.  r/k/v/w/dy (B, T, H, D); u (H, D); ``ckpt`` from
    the training form; ds (B, H, D, D) the final state's gradient or None
    (0).  Returns (dr, dk, dv in r/k/v's dtype, dw f32 (B, T, H, D), du f32
    (H, D), ds0 f32 (B, H, D, D))."""
    rwkv6_wkv_bwd_ref.calls += 1
    return _wkv_bwd_loop(r, k, v, w, u, ckpt, dy, ds, None)


def wkv_bwd_plan(D: int) -> tuple[int, int]:
    """``(P, RS)`` of kernel 7's backward at head dim D: a cluster of P =
    D / 16 CTAs a (b, h), each holding RS = 16 rows of the state (P <= 8,
    the portable cluster size).  The kernel instantiates the same."""
    return D // 16, 16


def rwkv6_wkv_bwd_split_ref(r, k, v, w, u, ckpt, dy, ds=None, *, P: int):
    """Kernel 7's backward with the kernel's partition of the rows (for
    the tests): the rows of G split into P groups of D / P, each group's
    dv partial (G_t^T k_t over its rows plus its part of c_t times dy_t)
    added in rank order; every other gradient is whole inside a group.
    Returns what ``rwkv6_wkv_bwd_ref`` returns."""
    D = r.shape[-1]
    if P < 1 or D % P:
        raise ValueError(f"rwkv6_wkv_bwd_split_ref: P={P} does not divide "
                         f"head dim {D}")
    return _wkv_bwd_loop(r, k, v, w, u, ckpt, dy, ds, P)


# calls of the plain training versions: a training run on the card shows
# that none ran there
rwkv6_wkv_train_ref.calls = 0
rwkv6_wkv_bwd_ref.calls = 0


def rwkv6_wkv_split_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor,
                        s0: torch.Tensor | None = None, *, q: int):
    """The kernel's arithmetic in plain torch (for the tests), as ``q``
    lanes a column hold it: per step c_t = sum_i r_i u_i k_i once; the
    rows in blocks of ``_ROW_BLOCK[D]``, block b in partial b mod P (P =
    ``_PARTS[D]``), each partial summed over its blocks in order; lane g
    holding the partials p = g (mod q) adds them as a butterfly (levels
    P/2 .. q), then the q lanes add theirs (levels q/2 .. 1); y_j is that
    sum plus v_j c_t, and the state updated as the plain version does.
    The products are rounded before they are added (the kernel fuses
    them), so the order is the kernel's, not its bits; the additions, and
    so the result, are the same for every ``q`` dividing P.  Returns (y,
    s) as ``rwkv6_wkv_ref``."""
    B, T, H, D = r.shape
    V, P = _ROW_BLOCK[D], _PARTS[D]
    if P % q:
        raise ValueError(f"rwkv6_wkv_split_ref: q={q} does not divide the "
                         f"{P} partials of head dim {D}")
    L = P // q
    s = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device) \
        if s0 is None else s0.float()
    uf = u.float()[None]
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        c = (rt * uf * kt).sum(-1)
        # (B, H, M, P, V, D): block m * P + p's row e of every column
        prod = (rt[..., :, None] * s).view(B, H, D // (V * P), P, V, D)
        part = torch.zeros(B, H, P, D, dtype=torch.float32, device=r.device)
        for m in range(prod.shape[2]):
            for e in range(V):
                part = part + prod[:, :, m, :, e]
        lanes = part.view(B, H, L, q, D)        # partial a * q + g
        o = L // 2
        while o:                                # levels P/2 .. q
            lanes = lanes[:, :, :o] + lanes[:, :, o:2 * o]
            o //= 2
        y = lanes[:, :, 0]                      # (B, H, q, D)
        o = q // 2
        while o:                                # levels q/2 .. 1
            y = y + y[:, :, torch.arange(q, device=r.device) ^ o]
            o //= 2
        ys.append(y[:, :, 0] + vt * c[..., None])
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    y = torch.stack(ys, dim=1) if ys \
        else r.new_zeros(r.shape, dtype=torch.float32)
    return y.to(r.dtype), s


@functools.cache
def _kernel():
    fn = build.library("rwkv6_wkv").rwkv6_wkv
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = build.library("rwkv6_wkv_bwd").rwkv6_wkv_bwd
    fn.argtypes = [ctypes.c_void_p] * 16
    fn.restype = ctypes.c_int
    return fn


# the launch's shape, plan, dtype and strides, one array a thread (the C
# call reads it before it returns), filled by one slice assignment: the
# ctypes call then converts 11 arguments, not 32
_LOCAL = threading.local()


def _params(name: str = "params", n: int = 20):
    arr = getattr(_LOCAL, name, None)
    if arr is None:
        arr = (ctypes.c_longlong * n)()
        setattr(_LOCAL, name, arr)
        setattr(_LOCAL, name + "_address", ctypes.addressof(arr))
    return arr, getattr(_LOCAL, name + "_address")


def _check(r, k, v, w, u, s0, s_out, *, name="rwkv6_wkv", hint="") -> None:
    build.refuse_grad(name, r, k, v, w, u, s0, hint=hint)
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_wkv: r must be on a CUDA device, got {dev}")
    named = [("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    if s_out is not None:
        named.append(("s_out", s_out))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"rwkv6_wkv: {name} must be on r's CUDA device, "
                             f"got {t.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"rwkv6_wkv: r on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    dt = r.dtype
    if dt not in _DTYPES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"rwkv6_wkv: r/k/v {dt}/{k.dtype}/{v.dtype}: "
                        f"need one of f32 or bf16")
    for name, t in named[2:]:
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_wkv: {name} must be f32, got {t.dtype}")
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape \
            or w.shape != shape:
        raise ValueError(f"rwkv6_wkv: r/k/v/w shapes {tuple(shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)} {tuple(w.shape)}")
    B, T, H, D = shape
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head dim {D} not in {HEAD_DIMS}")
    if u.shape != (H, D):
        raise ValueError(f"rwkv6_wkv: u {tuple(u.shape)} for {H} heads of {D}")
    for name, t in named[4:]:
        if t.shape != (B, H, D, D):
            raise ValueError(f"rwkv6_wkv: {name} {tuple(t.shape)}, need "
                             f"{(B, H, D, D)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"rwkv6_wkv: {name}'s head dim must be "
                             f"contiguous")
    for name, t in named[3:]:
        if not t.is_contiguous():
            raise ValueError(f"rwkv6_wkv: {name} must be contiguous")
    if s0 is not None and s_out is not None:
        a, b = s0.data_ptr(), s_out.data_ptr()
        if a != b and max(a, b) < min(a, b) + 4 * s0.numel():
            raise ValueError("rwkv6_wkv: s_out overlaps s0 without being it")


def _launch(r, k, v, w, u, s0, s_out, jc: int, q: int, ckpt=None):
    """One launch at a given (JC, Q) (the wrapper's plan, or the sweep's);
    with ``ckpt`` the training form, which writes the checkpoints there."""
    B, T, H, D = r.shape
    y = torch.empty_like(r, memory_format=torch.contiguous_format)
    if s_out is None:
        s_out = torch.empty(B, H, D, D, dtype=torch.float32, device=r.device)
    params, address = _params()
    params[:] = (B, T, H, D, jc, q, _DTYPES[r.dtype], *r.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
                 0 if ckpt is None else wkv_chunk(D))
    err = _kernel()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), s_out.data_ptr(), y.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), address,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "rwkv6_wkv")
    if ckpt is None:
        rwkv6_wkv.launches += 1
    else:
        rwkv6_wkv_train.launches += 1
    return y, s_out


def rwkv6_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              s0: torch.Tensor | None = None, *,
              s_out: torch.Tensor | None = None):
    """Launch the CUDA kernel (all tensors on the current CUDA device),
    split as ``wkv_plan`` says.  Returns (y, s); s is ``s_out`` when given
    (which may be ``s0``)."""
    _check(r, k, v, w, u, s0, s_out)
    B, _, H, D = r.shape
    return _launch(r, k, v, w, u, s0, s_out, *wkv_plan(B, H, D))


rwkv6_wkv.launches = 0


def rwkv6_wkv_train(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor,
                    s0: torch.Tensor | None = None):
    """Kernel 7's training form: the serve form's launch (the same plan,
    the same bits for y and s) that also writes the checkpoints.  Returns
    (y, s, ckpt (B, H, ceil(T / C), D, D) f32).  ``launches`` counts these
    launches apart from the serve form's.  ``ops.WkvFn`` calls it inside
    its forward, where no gradient is recorded."""
    _check(r, k, v, w, u, s0, None, name="rwkv6_wkv_train",
           hint="ops.rwkv6_wkv carries kernel 7's backward")
    B, T, H, D = r.shape
    C = wkv_chunk(D)
    ckpt = torch.empty(B, H, -(-T // C), D, D, dtype=torch.float32,
                       device=r.device)
    y, s = _launch(r, k, v, w, u, s0, None, *wkv_plan(B, H, D), ckpt=ckpt)
    return y, s, ckpt


rwkv6_wkv_train.launches = 0


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where its start and its (B, T, H) strides are whole
    16-byte units (the backward stages rows by 16-byte copies), else a
    contiguous copy (D % 16 == 0 puts every row of that on 16 bytes)."""
    el = t.element_size()
    if t.data_ptr() % 16 or any(st * el % 16 for st in t.stride()[:3]):
        return t.contiguous()
    return t


def rwkv6_wkv_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                  dy: torch.Tensor, ds: torch.Tensor | None = None):
    """Launch kernel 7's backward (a cluster of ``wkv_bwd_plan(D)[0]``
    CTAs a (b, h), each holding its rows of G in registers and its chunk's
    states on chip; no atomics, no scratch).  ``ckpt`` from
    ``rwkv6_wkv_train``; dy (B, T, H, D) in r's dtype; ds (B, H, D, D) f32
    or None (0).  Returns (dr, dk, dv in r's dtype, dw f32 (B, T, H, D), du
    f32 (H, D), ds0 f32 (B, H, D, D)) as ``rwkv6_wkv_bwd_ref`` does; du is
    the kernel's per-(b, h) partials summed over b by ``sum(0)`` (no
    atomics: the same bits on every run).  ``launches`` counts calls."""
    _check(r, k, v, w, u, None, None, name="rwkv6_wkv_bwd")
    B, T, H, D = r.shape
    C = wkv_chunk(D)
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device:
        raise ValueError(f"rwkv6_wkv_bwd: dy {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}, need r's {tuple(r.shape)} {r.dtype}")
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    want = (B, H, -(-T // C), D, D)
    if tuple(ckpt.shape) != want or ckpt.dtype != torch.float32 \
            or not ckpt.is_contiguous() or ckpt.device != r.device:
        raise ValueError(f"rwkv6_wkv_bwd: ckpt {tuple(ckpt.shape)} "
                         f"{ckpt.dtype}, need contiguous f32 {want}")
    if ds is not None and (tuple(ds.shape) != (B, H, D, D)
                           or ds.dtype != torch.float32
                           or not ds.is_contiguous()
                           or ds.device != r.device):
        raise ValueError(f"rwkv6_wkv_bwd: ds {tuple(ds.shape)} {ds.dtype}, "
                         f"need contiguous f32 {(B, H, D, D)}")
    r, k, v, w, dy = (_on_16_bytes(t) for t in (r, k, v, w, dy))
    dr, dk, dv = (torch.empty(B, T, H, D, dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dw = torch.empty(B, T, H, D, dtype=torch.float32, device=r.device)
    du_part = torch.empty(B, H, D, dtype=torch.float32, device=r.device)
    ds0 = torch.empty(B, H, D, D, dtype=torch.float32, device=r.device)
    params, address = _params("bwd_params", 21)
    params[:] = (B, T, H, D, C, _DTYPES[r.dtype], *r.stride()[:3],
                 *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
                 *dy.stride()[:3])
    err = _bwd_kernel()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ckpt.data_ptr(), None if ds is None else ds.data_ptr(), dy.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        du_part.data_ptr(), ds0.data_ptr(), address,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "rwkv6_wkv_bwd")
    rwkv6_wkv_bwd.launches += 1
    return dr, dk, dv, dw, du_part.sum(0), ds0


rwkv6_wkv_bwd.launches = 0
