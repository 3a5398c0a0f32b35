"""The kernels as ``torch.library`` ops on the CPU: the namespace's ops
are ``analysis.op_cost``'s work table, ``torch.library.opcheck`` passes
for every op at small shapes (``kernels.opcheck``'s cases: kernel 1's
three forms, kernel 5 with and without its ring, kernel 7 with ``s_out``
its ``s0``, kernel 6 in bf16 and f32 out), each fake gives its plain
version's shapes, dtypes and strides (and the meta device its shapes),
every op refuses a gradient and a mix of devices on every route, a
profiler trace names each op, and ``op_cost`` counts a decode step, a
chunk tick and two train steps as it counted them when a hook carried
the kernel calls."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import hashlib
import json

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis import op_cost
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.opcheck import CASES, check, inputs
from repro_torch.models import build_model, local_plan
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_step import make_train_step
from torch_cuda_route import cuda_route

IDS = [f"{op}-{case}" for op, case in CASES]


def test_registered_ops_are_the_work_table():
    """One op per kernel entry point, each with a formula: a kernel
    registered without one fails here."""
    assert ops.registered() == sorted(op_cost.KERNEL_WORK)
    assert {op for op, _ in CASES} == set(ops.registered())


@pytest.mark.parametrize("name", sorted(op_cost.KERNEL_WORK))
def test_each_op_has_its_three_routes_and_no_other(name):
    """A CUDA, a CPU and a Meta implementation, autograd passed through;
    no composite implementation that would run a plain version on the
    card."""
    qual = f"{ops.NAMESPACE}::{name}"
    has = lambda key: torch._C._dispatch_has_kernel_for_dispatch_key(  # noqa
        qual, key)
    assert all(has(k) for k in ("CUDA", "CPU", "Meta", "Autograd"))
    assert not any(has(k) for k in ("CompositeImplicitAutograd",
                                    "CompositeExplicitAutograd"))


@pytest.mark.parametrize("op,case", CASES, ids=IDS)
def test_opcheck_on_the_cpu(op, case):
    res = check(op, case, "cpu")
    assert res == {k: "SUCCESS" for k in res}, res
    assert set(res) == {"test_schema", "test_autograd_registration",
                        "test_faketensor", "test_aot_dispatch_dynamic"}


@pytest.mark.parametrize("op,case", CASES, ids=IDS)
def test_fake_is_the_plain_versions_layout(op, case):
    """The fake on CPU tensors gives what the plain version returns,
    strides too; on the meta device the same shapes and dtypes."""
    fn, args, kwargs = inputs(op, case)
    with torch.no_grad():
        want = list(op_cost._tensors(fn(*args, **kwargs)))
        with FakeTensorMode() as mode:
            fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                         else a for a in args]
            got = list(op_cost._tensors(fn(*fake_args, **kwargs)))
        meta = list(op_cost._tensors(fn(*[
            a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args], **kwargs)))
    assert [(t.shape, t.dtype, t.stride()) for t in got] == \
        [(t.shape, t.dtype, t.stride()) for t in want]
    assert [(t.shape, t.dtype) for t in meta] == \
        [(t.shape, t.dtype) for t in want]
    assert all(t.is_meta for t in meta)


@pytest.mark.parametrize("op,case", CASES, ids=IDS)
def test_every_route_refuses_a_gradient(op, case):
    """Called where autograd would need a backward, every op raises at
    forward time on the CPU, on the meta device and on the CUDA route,
    rather than cut the gradient; under no_grad it runs."""
    fn, args, kwargs = inputs(op, case)
    floats = [i for i, a in enumerate(args)
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
    leafy = list(args)
    leafy[floats[0]] = args[floats[0]].clone().requires_grad_(True)
    for dev, route in (("cpu", None), ("meta", None), ("cpu", cuda_route)):
        on = [a.to(dev) if isinstance(a, torch.Tensor) else a
              for a in leafy]
        with pytest.raises(RuntimeError, match="no backward"):
            if route is None:
                fn(*on, **kwargs)
            else:
                with route():
                    fn(*on, **kwargs)
    with torch.no_grad():
        fn(*leafy, **kwargs)


def test_kernels_1_and_7_differentiate_through_their_functions():
    """Only kernels 1 and 7 carry a gradient, through ``FlashAttentionFn``
    and ``WkvFn`` over their ops."""
    _, args, _ = inputs("flash_attention_lse", "causal")
    q = args[0].clone().requires_grad_(True)
    o = ops.flash_attention(q, *args[1:])
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert torch.autograd.grad(o.sum(), q)[0].shape == q.shape
    _, (r, k, v, w, u, s0), _ = inputs("rwkv6_wkv_train", "from s0")
    u = u.clone().requires_grad_(True)
    y, _ = ops.rwkv6_wkv(r, k, v, w, u, s0)
    assert type(y.grad_fn).__name__ == "WkvFnBackward"
    assert torch.autograd.grad(y.sum(), u)[0].shape == u.shape
    _, args, _ = inputs("paged_decode_attention", "plan")
    q = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_decode_attention(q, *args[1:])


@pytest.mark.parametrize("op,case", CASES, ids=IDS)
def test_every_route_refuses_a_mix_of_devices(op, case):
    """A CPU tensor beside a meta one raises ``ValueError`` on the meta
    route (the dispatcher's pick for the mix) and on the CUDA route (its
    pick for a mix of CPU and CUDA tensors: the kernel's wrapper takes
    CUDA tensors on one device only)."""
    fn, args, kwargs = inputs(op, case)
    mixed = [a.to("meta") if i == 0 else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="devices"):
        fn(*mixed, **kwargs)
    with cuda_route(), pytest.raises(ValueError):
        fn(*mixed, **kwargs)


def test_a_profiler_trace_names_each_op():
    """Each kernel call is one op on the host side of a trace, named
    ``repro_torch::<name>``, whatever runs under it."""
    calls = [inputs(op, case) for op, case in CASES]
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for fn, args, kwargs in calls:
            fn(*args, **kwargs)
    names = {e.key for e in prof.key_averages()}
    assert {f"{ops.NAMESPACE}::{op}" for op, _ in CASES} <= names


# op_cost's counts of four CPU steps when ``kernels.ops`` handed each
# kernel call to a hook: flops, bytes, gemm flops, kernel flops, kernel
# bytes, peak live bytes, the kernels' rows, and a digest of the census
# (sha256 of its sorted JSON, 16 hex digits)
COUNTED = {
    "decode llama2-7b": (
        (526553, 294660, 491520, 27648, 15448, 238592),
        {"paged_decode_attention": {"calls": 2, "flops": 27648,
                                    "bytes": 15448}},
        "054dffbb45afc9f8"),
    "chunk llama2-7b": (
        (2484212, 852800, 2392064, 53248, 13352, 266880),
        {"paged_prefill_attention": {"calls": 2, "flops": 53248,
                                     "bytes": 13352}},
        "a2424158b99c7983"),
    "train llama2-7b": (
        (18771618, 23895556, 16252928, 487424, 75776, 2070564),
        {"flash_attention_bwd": {"calls": 2, "flops": 348160,
                                 "bytes": 50176},
         "flash_attention_lse": {"calls": 2, "flops": 139264,
                                 "bytes": 25600}},
        "28199567de18c37f"),
    "train rwkv6-3b": (
        (30668090, 37458820, 26083328, 1314816, 206336, 3204644),
        {"rwkv6_wkv_bwd": {"calls": 2, "flops": 966656, "bytes": 123904},
         "rwkv6_wkv_train": {"calls": 2, "flops": 348160, "bytes": 82432}},
        "a612fa790edaba74"),
}


def _step_count(step: str) -> dict:
    kind, arch = step.split()
    cfg = get_config(arch).smoke_config()
    if kind == "train":
        model = build_model(cfg, local_plan(), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        opt = init_opt_state(params)
        g = torch.Generator().manual_seed(1)
        inputs_ = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                                dtype=torch.int32)
        labels = torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                               dtype=torch.int32)
        return op_cost.count(make_train_step(model, AdamWConfig()), params,
                             opt, inputs_, labels, live=(params, opt))[1]
    model = build_model(cfg, local_plan(param_dtype=torch.bfloat16),
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    pool = model.init_paged_cache(25, 8)
    with torch.inference_mode():
        if kind == "decode":
            return op_cost.count(
                model.decode_step_paged, params, pool,
                torch.tensor([5, 9, 11], dtype=torch.int32),
                torch.tensor([4, 17, 30], dtype=torch.int32),
                torch.arange(24, dtype=torch.int32).reshape(3, 8) + 1,
                live=(params, pool), breakdown=True)[1]
        return op_cost.count(
            model.prefill_chunk_paged, params, pool,
            torch.arange(16, dtype=torch.int32).reshape(2, 8) % 100,
            torch.tensor([0, 4], dtype=torch.int32),
            torch.tensor([8, 3], dtype=torch.int32),
            torch.arange(16, dtype=torch.int32).reshape(2, 8) + 1,
            live=(params, pool), breakdown=True)[1]


@pytest.mark.parametrize("step", sorted(COUNTED))
def test_counts_are_those_of_the_hook(step):
    cost = _step_count(step)
    totals, kernels, census = COUNTED[step]
    assert tuple(cost[k] for k in (
        "flops", "bytes", "gemm_flops", "kernel_flops", "kernel_bytes",
        "peak_live_bytes")) == totals
    assert cost["kernels"] == kernels
    digest = hashlib.sha256(json.dumps(cost["census"], sort_keys=True)
                            .encode()).hexdigest()[:16]
    assert digest == census, cost["census"]
