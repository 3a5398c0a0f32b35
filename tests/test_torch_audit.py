"""The port's static audit (``repro_torch.analysis.iraudit``) on the CPU
and the meta device: every registered entry clean at smoke geometry,
under the JAX registry's names; one synthetic fault per invariant code
flagged with that code (gemma-7b's former host-built tensor in
``_embed_inputs`` among them) and a clean synthetic with none; the budget functions on
synthetic rows; the entry point."""
import torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
import torch

from repro_torch.analysis.iraudit import (ENTRYPOINTS, ENTRYPOINTS_BY_NAME,
                                          INVARIANTS, AuditContext,
                                          audit_built, audit_entry,
                                          budget_row, census_diff,
                                          check_budgets, cost_metrics,
                                          run_invariants)
from repro_torch.analysis.iraudit import __main__ as iraudit_main
from repro_torch.analysis.iraudit.__main__ import main
from repro_torch.analysis.iraudit.registry import (SYNTHETIC_FAULTS,
                                                   Entrypoint, synthetic)

DEVICES = ("cpu", "meta")
_CTX: dict = {}


def _ctx(device) -> AuditContext:
    if device not in _CTX:
        _CTX[device] = AuditContext(device=device)
    return _CTX[device]


def test_entry_names_match_the_reference_registry():
    jax = pytest.importorskip("jax")  # noqa: F841
    from repro.analysis.iraudit.registry import ENTRYPOINTS as J_ENTRIES
    names = [e.name for e in ENTRYPOINTS]
    assert len(set(names)) == len(names)
    for e in J_ENTRIES:
        assert e.name in ENTRYPOINTS_BY_NAME, e.name
        assert ENTRYPOINTS_BY_NAME[e.name].kind == e.kind
        assert ENTRYPOINTS_BY_NAME[e.name].f32_dot_ok == e.f32_dot_ok
    assert set(names) - {e.name for e in J_ENTRIES} == {"decode_slot_step"}


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("name", [e.name for e in ENTRYPOINTS])
def test_registered_entry_is_clean(name, device):
    ctx = _ctx(device)
    audit = audit_entry(ENTRYPOINTS_BY_NAME[name], ctx)
    assert run_invariants(audit, ctx.model.plan.compute_dtype) == []
    row = cost_metrics(audit)
    assert row["n_ops"] > 0 and row["flops"] >= 0 and row["bytes"] > 0
    assert row["kept_leaves"] == row["inplace_leaves"]
    assert not audit.trace.stopped
    census = row["census"]
    if name.startswith("kernel_"):
        assert list(census) == [f"kernel:{name[7:]}_attention"]
    if name in ("decode_step_paged", "decode_multi_paged_h4"):
        assert census["kernel:paged_decode_attention"] == \
            ctx.cfg.num_layers * (4 if name.endswith("h4") else 1)
    if name.endswith("@1x2"):
        assert any(k.endswith("_lse") for k in census), census


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fault", list(SYNTHETIC_FAULTS))
def test_synthetic_fault_is_flagged_with_its_code(fault, device):
    ctx = _ctx(device)
    entry = Entrypoint(f"synthetic_{fault}", "model", lambda c: None)
    audit = audit_built(entry, synthetic(ctx, fault), ctx.device)
    codes = {f.code for f in run_invariants(audit)}
    want = SYNTHETIC_FAULTS[fault]
    if want is None:
        assert codes == set()
    else:
        assert codes == {want}, (fault, codes)
    if fault == "item":
        # the meta device has no value to read: the trace stops there
        assert bool(audit.trace.stopped) == (device == "meta")


def _row(**kw):
    row = {"flops": 1000.0, "bytes": 5000.0, "peak_live_bytes": 400,
           "arg_bytes": 64, "out_bytes": 12, "n_ops": 7, "f32_out_bytes": 8,
           "const_count": 1, "const_bytes": 8, "inplace_leaves": 2,
           "kept_leaves": 2, "census": {"mm": 2, "add": 5}}
    row.update(kw)
    return row


def test_check_budgets_and_census_diff_on_synthetic_rows():
    pinned = {"meta": {"torch": "2.x"}, "entries": {"a": _row(),
                                                    "b": _row()}}
    assert budget_row(_row()) == _row()
    assert check_budgets({"a": _row(), "b": _row()}, pinned, "2.x") == []
    # inside the tolerances: 2% on flops and bytes, 5% on the peak
    ok = _row(flops=1019.0, bytes=5099.0, peak_live_bytes=419)
    assert check_budgets({"a": ok, "b": _row()}, pinned, "2.x") == []
    bad = _row(flops=1021.0, peak_live_bytes=421, kept_leaves=1,
               census={"mm": 3, "mul": 1})
    problems = check_budgets({"a": bad, "b": _row()}, pinned, "2.x")
    assert any(p.startswith("a: flops") and "2%" in p for p in problems)
    assert any(p.startswith("a: peak_live_bytes") and "5%" in p
               for p in problems)
    assert "a: kept_leaves 1 vs budget 2 (exact)" in problems
    assert ("a: op census drift — added mul(+1); removed add(-5); changed "
            "mm 2->3") in problems
    assert len(problems) == 4
    missing = check_budgets({"a": _row(), "c": _row()}, pinned, "2.x")
    assert missing == [
        "b: pinned but not registered (stale budget row — re-record)",
        "c: registered but has no budget row — record it"]
    skew = check_budgets({"a": _row()}, pinned, "3.0")
    assert len(skew) == 1 and skew[0].startswith("toolchain skew")
    assert census_diff({"a": 1}, {"a": 1}) == "identical"


def test_entry_point_explains_and_audits(capsys, monkeypatch):
    for code in INVARIANTS:
        assert main(["--explain", code.lower()]) == 0
        assert capsys.readouterr().out.startswith(code)
    assert main(["--explain", "IR999"]) == 2
    assert "off on the CPU" in " ".join(INVARIANTS["IR001"][1].split())
    # the audit loop over two of the entries (every entry is audited on
    # cpu and meta above), on the meta device
    monkeypatch.setattr(iraudit_main, "ENTRYPOINTS", tuple(
        ENTRYPOINTS_BY_NAME[n] for n in ("pool_mirror_row",
                                         "kernel_paged_decode")))
    assert main(["--device", "meta"]) == 0
    out = capsys.readouterr().out
    assert "pool_mirror_row: clean" in out and "2 entries on meta, 0 " \
        "findings" in out
    monkeypatch.setattr(iraudit_main, "ENTRYPOINTS", (Entrypoint(
        "synthetic_item", "model",
        lambda c: synthetic(c, "item")),))
    assert main(["--device", "meta"]) == 1
    assert "IR001" in capsys.readouterr().out


def test_audit_runs_on_the_card_unless_asked_otherwise():
    import inspect
    assert inspect.signature(AuditContext).parameters["device"].default \
        == "cuda"
    assert iraudit_main.parser().parse_args([]).device == "cuda"
