"""Roofline terms and every kernel's work count, for one H100 (port of
``repro.analysis.roofline``).

The reference's three terms, in seconds, per (arch x shape x mesh):

    compute    = flops_total      / (chips * peak_FLOPs)
    memory     = bytes_total      / (chips * HBM_bw)
    collective = collective_bytes / link_bw

with the flops and bytes counted by ``analysis/op_cost.py`` (the port's
counterpart of ``hlo_cost.py``) where the reference parses compiled HLO.
The port runs on one card and keeps every stripe on it, so no collective
moves a byte: ``t_collective`` is 0 on every cell (the term stays, as
``coll_bytes_per_dev`` 0, so a row keeps the reference's fields).

Every kernel's work is counted here, one function per kernel row of
``PERF.md`` §6.  Each returns ``(bytes, flops, peak)``: the bytes the call
must move (each input read once, each output written once), the flops it
must compute, and the name of the peak its inputs run at
(``HWSpec.peak``).  Data-dependent counts (live keys, owned rows, seen
pairs) are arguments: ``op_cost.kernel_work`` reads them off a call's
tensors.  ``bound_of`` turns a count into the least time the card could
take.  ``chip_smoke.py`` phase 1 and ``op_cost`` both count through these
functions, so a kernel and its plain version are held to the same work.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class HWSpec:
    """One accelerator's peaks.  The default is the H100 SXM's (NVIDIA
    data sheet, dense): 3.35 TB/s of HBM3, 989 TFLOP/s bf16, 67 TFLOP/s
    f32 (no TF32), 1979 TOP/s int8, 80 GB; NVLink 4 at 450 GB/s a
    direction (read by ``t_collective`` only, 0 on one card)."""
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12
    hbm_bw: float = 3.35e12
    link_bw: float = 450e9
    hbm_bytes: float = 80e9
    peak_flops_f32: float = 67e12
    peak_ops_int8: float = 1979e12

    def peak(self, name: str) -> float:
        return {"bf16": self.peak_flops_bf16, "f32": self.peak_flops_f32,
                "int8": self.peak_ops_int8}[name]


HW = HWSpec()


def peak_name(*dtypes) -> str:
    """The peak of the lowest precision among ``dtypes``: int8, bf16 (or
    f16) or f32."""
    if torch.int8 in dtypes:
        return "int8"
    if torch.bfloat16 in dtypes or torch.float16 in dtypes:
        return "bf16"
    return "f32"


def bound_of(n_bytes: int, flops: int, peak: str,
             hw: HWSpec = HW) -> tuple[float, str]:
    """(least time in ms, what bounds it): bytes over HBM bandwidth or
    flops over the peak of the input type, whichever is larger."""
    t_bytes, t_ops = n_bytes / hw.hbm_bw, flops / hw.peak(peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# kernel work, one function per row of PERF.md §6
# ---------------------------------------------------------------------------

def window_pairs(S: int, W: int) -> int:
    """(query, key) pairs a causal window of W keys sees over S queries."""
    W = min(W, S)
    return W * (W + 1) // 2 + (S - W) * W


def attn_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs seen per (batch, head)."""
    if causal:
        return window_pairs(S, window) if window else S * (S + 1) // 2
    if 0 < window < S:                  # keys k > q - W, every later one
        return sum(S - max(0, q - window + 1) for q in range(S))
    return S * S


def flash_attention_work(B: int, H: int, K: int, S: int, D: int, dtype, *,
                         causal: bool = True, window: int = 0,
                         lse: bool = False) -> tuple:
    """Rows 1, 1w and 1b (and the training forward with ``lse``): q and o
    per query head, k and v per KV head, each moved once (and the f32
    lse written); 4 D flops per seen (query, key) pair and head."""
    el = dtype.itemsize
    n_bytes = 2 * B * S * (H + K) * D * el + (4 * B * H * S if lse else 0)
    flops = 4 * D * B * H * attn_pairs(S, causal, window)
    return n_bytes, flops, peak_name(dtype)


def flash_attention_bwd_work(B: int, H: int, K: int, S: int, D: int, dtype,
                             *, causal: bool = True,
                             window: int = 0) -> tuple:
    """Row 1∂: 10 D flops per seen pair (S = Q K^T recomputed, dP, dV, dK,
    dQ: 2.5 times the forward's 4 D); bytes: q, o, dO and dq per query
    head, k, v, dk and dv per KV head, the f32 lse."""
    flops = 10 * D * B * H * attn_pairs(S, causal, window)
    n_bytes = 4 * B * S * (H + K) * D * dtype.itemsize + 4 * B * H * S
    return n_bytes, flops, peak_name(dtype)


def paged_decode_work(B: int, H: int, K: int, D: int, q_dtype, kv_dtype,
                      keys: int, live_blocks: int) -> tuple:
    """Row 2: K and V of the ``keys`` live keys, q in and o out, the live
    blocks' table ids and the positions; 4 D flops per live key and query
    head."""
    n_bytes = (2 * keys * K * D * kv_dtype.itemsize
               + 2 * B * H * D * q_dtype.itemsize + 4 * live_blocks + 4 * B)
    return n_bytes, 4 * D * H * keys, peak_name(q_dtype, kv_dtype)


def paged_decode_lse_work(B: int, H: int, K: int, D: int, q_dtype, kv_dtype,
                          keys: int, slots_seen: int, blocks: int) -> tuple:
    """Row 4, one stripe's launch: the stripe's owned live K and V, q in,
    o and the f32 lse out, the owned mask over the table slots the walk
    sees, the owned blocks' ids and the positions."""
    n_bytes = (2 * keys * K * D * kv_dtype.itemsize
               + 2 * B * H * D * q_dtype.itemsize + 4 * B * H
               + 4 * (slots_seen + blocks + B))
    return n_bytes, 4 * D * H * keys, peak_name(q_dtype, kv_dtype)


def paged_prefill_work(B: int, C: int, H: int, K: int, D: int, q_dtype,
                       kv_dtype, keys: int, pairs: int,
                       table_blocks: int) -> tuple:
    """Row 3: the ``keys`` distinct K/V rows the lanes read, q in and o
    out, the table ids each lane walks and the starts; 4 D flops per seen
    (query, key) pair and head."""
    n_bytes = (2 * keys * K * D * kv_dtype.itemsize
               + 2 * B * C * H * D * q_dtype.itemsize + 4 * table_blocks
               + 4 * B)
    return n_bytes, 4 * D * H * pairs, peak_name(q_dtype, kv_dtype)


def paged_prefill_lse_work(B: int, C: int, H: int, K: int, D: int, q_dtype,
                           kv_dtype, rows: int, pairs: int,
                           table_blocks: int) -> tuple:
    """Row 3s, one stripe's launch: the ``rows`` distinct owned K/V rows
    some query sees, q in, o and the f32 lse out, the table ids and the
    owned mask of each walked slot, the starts; 4 D flops per owned seen
    pair and head."""
    n_bytes = (2 * rows * K * D * kv_dtype.itemsize
               + 2 * B * C * H * D * q_dtype.itemsize + 4 * B * C * H
               + 8 * table_blocks + 4 * B)
    return n_bytes, 4 * D * H * pairs, peak_name(q_dtype, kv_dtype)


def decode_work(B: int, H: int, K: int, D: int, q_dtype, kv_dtype,
                keys: int) -> tuple:
    """Row 5 (slot cache or ring): K and V of the live keys, q in and o
    out, the positions; 4 D flops per live key and query head."""
    n_bytes = (2 * keys * K * D * kv_dtype.itemsize
               + 2 * B * H * D * q_dtype.itemsize + 4 * B)
    return n_bytes, 4 * D * H * keys, peak_name(q_dtype, kv_dtype)


def int8_matmul_work(M: int, K: int, N: int, out_dtype) -> tuple:
    """Row 6: x and w read once (int8), the f32 scales once, the output
    written once; 2 M N K integer operations at the int8 peak."""
    n_bytes = M * K + K * N + 4 * (M + N) + out_dtype.itemsize * M * N
    return n_bytes, 2 * M * N * K, "int8"


def wkv_work(B: int, T: int, H: int, D: int, dtype, *,
             state_in: bool) -> tuple:
    """Row 7: r/k/v (``dtype``) and w (f32) read once, y written once, u
    read, the state read (when given) and written once.  Flops in the form
    y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i: per step and (b, h), 5
    per state entry (the FMA of r_i S_ij; w_i S_ij plus k_i v_j) and 5
    per row (r_i u_i k_i summed, 3; the FMA of v_j with it, 2); f32."""
    n_bytes = (B * T * H * D * (4 * dtype.itemsize + 4) + H * D * 4
               + (1 + state_in) * B * H * D * D * 4)
    flops = 5 * B * T * H * D * D + 5 * B * T * H * D
    return n_bytes, flops, "f32"


def wkv_train_work(B: int, T: int, H: int, D: int, dtype, n_ck: int, *,
                   state_in: bool = False) -> tuple:
    """Row 7's training form: row 7's work and its ``n_ck`` f32
    checkpoints of the state written."""
    n_bytes, flops, peak = wkv_work(B, T, H, D, dtype, state_in=state_in)
    return n_bytes + B * H * n_ck * D * D * 4, flops, peak


def wkv_bwd_work(B: int, T: int, H: int, D: int, dtype, n_ck: int, *,
                 ds_in: bool) -> tuple:
    """Row 7∂: r, k, v and dy (``dtype``) and w (f32) read once, u, the
    ``n_ck`` checkpoints and dS_T (when given) read once; dr, dk, dv
    (``dtype``) and dw (f32) written once, du and ds0 once.  Flops per
    step and (b, h): 14 an entry of the state (the state recomputed, 3; S
    dy, G v, G^T k and the row sums of G * S, 2 each; G's update, 3) and
    12 a row (v . dy, c_t and the u terms)."""
    el = dtype.itemsize
    n_bytes = (B * T * H * D * (4 * el + 4) + H * D * 4
               + B * H * n_ck * D * D * 4 + ds_in * B * H * D * D * 4
               + B * T * H * D * (3 * el + 4) + H * D * 4
               + B * H * D * D * 4)
    flops = B * T * H * (14 * D * D + 12 * D)
    return n_bytes, flops, "f32"


# ---------------------------------------------------------------------------
# step-level roofline (the reference's report)
# ---------------------------------------------------------------------------

def model_flops(n_params_active: int, shape_kind: str, tokens: int) -> float:
    """6*N*D for train, 2*N*D for prefill, 2*N*B for decode (per step)."""
    if shape_kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: dict = field(default_factory=dict)
    model_flops_total: float = 0.0
    peak_mem_per_dev: float = 0.0
    hw: HWSpec = HW

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self.hw.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_dev * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: (MODEL_FLOPS / chips / peak) / max(terms)."""
        ideal = self.model_flops_total / self.chips / self.hw.peak_flops_bf16
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return ideal / bound if bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "hlo_flops_total": self.flops_per_dev * self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_mem_per_dev_gb": self.peak_mem_per_dev / 1e9,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
        }


def roofline_terms(*, arch: str, shape: str, mesh: str, chips: int,
                   cost: dict, model_flops_total: float, peak_mem: float,
                   hw: HWSpec = HW) -> RooflineReport:
    """The three-term roofline from a counted cost (``op_cost.count``'s
    ``flops`` and ``bytes`` over the whole step, kernels by their
    formulas) where the reference parses HLO text.  ``hlo_flops_total``
    keeps the reference's key and holds the counted flops.  No collective
    runs on one card: ``coll_bytes_per_dev`` is 0."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_dev=float(cost["flops"]) / chips,
        bytes_per_dev=float(cost["bytes"]) / chips,
        coll_bytes_per_dev=0.0, coll_breakdown={},
        model_flops_total=model_flops_total, peak_mem_per_dev=peak_mem,
        hw=hw)


__all__ = ["HW", "HWSpec", "RooflineReport",
           "attn_pairs", "bound_of", "decode_work", "flash_attention_bwd_work",
           "flash_attention_work", "int8_matmul_work", "model_flops",
           "paged_decode_lse_work", "paged_decode_work",
           "paged_prefill_lse_work", "paged_prefill_work", "peak_name",
           "roofline_terms", "window_pairs", "wkv_bwd_work",
           "wkv_train_work", "wkv_work"]
