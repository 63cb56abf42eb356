"""Times kernel D (csrc/nfa_layered.cu) against copies of itself with its
short paths switched off, on one card in one call, so that what each
short path is worth is measured rather than assumed.

A variant is the kernel's source with conditions replaced by `false`
(VARIANTS: name -> the texts replaced), so the general path does that
work; a variant whose text the source no longer holds is reported as
absent. Each variant is built with the port's nvcc flags into
`hyperscan_tpu_torch/build/variants/` (all at once), loaded in place of
the kernel's library, held exact against `nfa_layered_plain` on each
engine and shape, and timed in turns: the kernel, each variant, each
variant again in reverse order, the kernel again. The engines are kernel
D's four A/B engines over the 256 MiB engine corpus of chip_smoke.py, as
one block and as 16,384 blocks.

Usage, on a machine with a CUDA card:

    python3 tools_torch_nfa_variants.py [--reps 10]

Prints one JSON line: the card's name and power limit, each variant's
build report (registers) or absence, and per engine and shape the ms of
each turn.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

# name -> [(text in the source, what replaces it)]
_GROUP = ("if (plain == all && !accm) {", "if (false) {")
_RUN = ("if (pl == 0xFu) {", "if (false) {")
_FLOAT = ("} else if ((fl >> i) & 1u) {", "} else if (false) {")
_SMALL = ("const bool small = K <= 4;", "const bool small = false;")
# the FLOAT-alone path (a FLOAT position with nothing else: cw & valid)
# measured no faster than the general path and was taken out
VARIANTS = {
    "no_group_loop": [_GROUP],
    "no_plain_run": [_RUN],
    "no_float_path": [_FLOAT],
    "no_small_classes": [_SMALL],
    "general_only": [_GROUP, _RUN, _SMALL],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import torch

    if not torch.cuda.is_available():
        print("tools_torch_nfa_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from hyperscan_tpu_torch.database import compile_patterns
    from hyperscan_tpu_torch.grey import Grey
    from hyperscan_tpu_torch.ops import _build
    from hyperscan_tpu_torch.ops import nfa_kernel as NK
    from hyperscan_tpu_torch.tools.benchdata import (NFA_ENGINES,
                                                     plant_many_class)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = "cuda"

    # build the kernel and every variant its source still allows
    src = _build.sources()["nfa_layered"].read_text()
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    built, procs = {}, {}
    for name, edits in VARIANTS.items():
        if any(src.count(old) != 1 for old, _new in edits):
            built[name] = "absent"
            continue
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        cu = vdir / f"nfa_layered_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    _build.build(["nfa_layered"])
    libs = {"kernel": _build.library("nfa_layered")}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        text = out.decode(errors="replace")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{text}")
        built[name] = [ln.strip() for ln in text.splitlines()
                       if "registers" in ln]
        libs[name] = ctypes.CDLL(str(so))

    def use(name):
        _build._libs["nfa_layered"] = libs[name]

    def ms(fn):
        return CS.cuda_ms(torch, fn, args.reps)

    engines = {"bench": (r".*a.{18}b", {}),
               "p62": (r".*a.{60}b", {"max_dfa_states": 8}),
               **NFA_ENGINES}
    corpus = plant_many_class(CS.gen_engine_corpus(CS.ENGINE_BYTES, 5),
                              1000, 65_537)
    corpus_t = torch.from_numpy(corpus).to(dev)
    names = list(libs)
    order = names + names[:0:-1] + names[:1]  # kernel, v..., ...v, kernel
    out = {}
    for ename, (pat, grey) in engines.items():
        eng = compile_patterns([pat], [0], grey=Grey(**grey)).engines[0]
        plan = NK.device_plan(eng, dev)
        for shape in ("one_block", "blocks_16k"):
            lens = [len(b) for b in CS.engine_blocks(corpus, shape)]
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            bs, be, ba, _ne = NK.block_bounds(
                starts, lens, np.ones(len(lens), bool), dev)
            cap = 1 << 22
            rp, tp, ep = NK.nfa_layered_plain(corpus_t, plan, bs, be, ba,
                                              cap)
            k = int(tp)
            want = rp[:k].long()[torch.argsort(rp[:k, 0])]
            for name in names:
                use(name)
                rk, tk, ek = NK.nfa_layered(corpus_t, plan, bs, be, ba, cap)
                got = rk[:k].long()[torch.argsort(rk[:k, 0])]
                if not (int(tk) == k <= cap and torch.equal(ek, ep)
                        and torch.equal(got, want)):
                    raise SystemExit(f"{name} on {ename} {shape} != plain")
            turns = {name: [] for name in names}
            for name in order:
                use(name)
                turns[name].append(ms(lambda: NK.nfa_layered(
                    corpus_t, plan, bs, be, ba, max(1, k))))
            out[f"{ename} {shape}"] = dict(records=k, ms=turns)
            del rp, ep, want
    use("kernel")
    print(json.dumps({"card": card, "built": built, "reps": args.reps,
                      "turns": "kernel, variants, variants reversed, "
                               "kernel", "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
