"""Target -> drafter pairing table for speculative decoding (port of
``repro.configs.drafters``).

A drafter proposes tokens the target then verifies, so the two models must
share a tokenizer (an exact vocab match here), and the drafter must be
paged-servable: its KV rides the target pool's block tables, which only
plain causal GQA supports.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig

# target arch name -> the small same-tokenizer variant that drafts for it
DRAFT_PAIRS = {
    "llama2-70b": "llama2-7b",
    "llama2-13b": "llama2-7b",
    "qwen3-moe-235b-a22b": "qwen3-1.7b",
}


def drafter_for(name: str) -> str | None:
    """The paired drafter arch for a target, or None if none is known."""
    return DRAFT_PAIRS.get(name)


def check_draft_pair(target: ArchConfig, draft: ArchConfig) -> None:
    """Validate a (target, drafter) pairing; raises ValueError if unfit."""
    if target.vocab_size != draft.vocab_size:
        raise ValueError(
            f"drafter {draft.name!r} (vocab {draft.vocab_size}) does not "
            f"share a tokenizer with target {target.name!r} "
            f"(vocab {target.vocab_size})")
    if (draft.rwkv or draft.family == "hybrid" or draft.attn_kind != "gqa"
            or not draft.causal or draft.input_kind != "tokens"):
        raise ValueError(
            f"drafter {draft.name!r} is not paged-servable "
            f"(family={draft.family!r}, attn_kind={draft.attn_kind!r})")
