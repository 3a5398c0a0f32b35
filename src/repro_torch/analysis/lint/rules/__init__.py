"""Rule registry: one instance per TL rule, in code order."""
from repro_torch.analysis.lint.rules.tl001_determinism import DeterminismRule
from repro_torch.analysis.lint.rules.tl002_host_sync import HostSyncRule
from repro_torch.analysis.lint.rules.tl003_retrace import RetraceRule
from repro_torch.analysis.lint.rules.tl004_dataclass_copy import DataclassCopyRule
from repro_torch.analysis.lint.rules.tl005_units import UnitSuffixRule
from repro_torch.analysis.lint.rules.tl006_protocol import ProtocolConformanceRule
from repro_torch.analysis.lint.rules.tl007_swallowed_error import SwallowedErrorRule
from repro_torch.analysis.lint.rules.tl008_np_const import NpConstRule

ALL_RULES = [
    DeterminismRule(),
    HostSyncRule(),
    RetraceRule(),
    DataclassCopyRule(),
    UnitSuffixRule(),
    ProtocolConformanceRule(),
    SwallowedErrorRule(),
    NpConstRule(),
]

RULES_BY_CODE = {r.code: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_CODE"]
