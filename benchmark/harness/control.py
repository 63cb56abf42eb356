"""The control of each configuration: the reference put in the program's
place with one guarantee that the configuration states broken, judged by
the same comparison as a run (`loops.Check`). A control that the
comparison passes would show the comparison blind to that fault.

The configuration's reference (`cfg["reference"]`) lists its controls by
name in `CONTROLS`, and `cfg["control"]` picks one: a function of the
form of the reference's `block_matches` (for blocks) or
`stream_matches` (for flows), whose answers stand in for the program's.
"""

from __future__ import annotations

from . import spec


def check(loop, cfg: dict):
    """The control's reading over the loop's sample."""
    return loop.check(cfg, answer=spec.reference(cfg).CONTROLS[cfg["control"]])
