"""Text rankers by kind: what the harness needs of the ranker that scores a
configuration's k candidates, found by the kind its `text_ranker` names.

A kind is a module `portbench/harness/rankers/<kind>.py` with

  build(cfg, seed, device)         the program's ranker, its weights drawn
                                   from seed + 2 by weights.materialize's
                                   rules, with its tokenizer;
  weights(cfg, seed, device)       the same draw as the tree the plain
                                   reference scores with;
  prompt_tokens(cfg, descriptions) the ranker's text tokens a prompt of a
                                   group (GroupShape.rank_text; 0 for a
                                   kind that reads none);
  flops(cfg, g)                    the ranker's operations on one group;
  encoder_launches(cfg, g)         {rows a launch: launches} of codec
                                   encodes the ranker runs over the group's
                                   samples (counted in kernel 3's roofline).

Its widths sit in a block of the configuration file of its own, and the
configuration's `reference` module scores with it (`score`,
`separate_candidates`).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Optional


def for_config(cfg: dict) -> Optional[ModuleType]:
    """The module of the configuration's text ranker, or None where it has
    none."""
    ranker = cfg.get("text_ranker")
    if not ranker:
        return None
    kind = ranker["kind"]
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{kind}":
            raise
        raise ValueError(f"no ranker of kind {kind!r} in the benchmark: add "
                         f"portbench/harness/rankers/{kind}.py") from None
