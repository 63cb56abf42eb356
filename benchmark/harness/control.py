"""The control of each configuration: the reference put in the program's
place with one guarantee that the configuration states broken, judged by
the same comparison as a run (`loops.Check`). A control that the
comparison passes would show the comparison blind to that fault.

- "single_match": each rule reported once a block, at its first end
  (HS_FLAG_SINGLEMATCH's semantics; the configuration reports every end);
- "write_alone": each write of a flow scanned by itself, without history
  or carried state (the configuration finds matches across writes).
"""

from __future__ import annotations

from reference import snort_rules as R


def answer_for(cfg: dict, n_patterns: int, write: int = 0):
    """The control's stand-in for the program's answer, in the form that
    the loop's `check(answer=...)` takes."""
    if cfg["control"] == "single_match":
        return R.single_match
    if cfg["control"] == "write_alone":
        return lambda _want, data, r: R.write_alone(data, r, write,
                                                     n_patterns)
    raise ValueError(f"unknown control {cfg['control']!r}")


def check(loop, cfg: dict, n_patterns: int):
    """The control's reading over the loop's sample."""
    write = getattr(loop.t, "write", 0)
    return loop.check(n_patterns, answer=answer_for(cfg, n_patterns, write))
