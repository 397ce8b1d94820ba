"""Time K4 ``rules_eval`` and K1 ``flat_probe_ranges`` built from this
checkout's sources against the same kernels built from other checkouts
(for example a git archive of the parent commit), on one card, in turns.

    python3 -m mqtt_tpu_torch.compare_kernels --against DIR [--against DIR2]

Run from the root of a checkout, beside ``chip_smoke.py``, whose table
builders and timing it uses. Each build is compiled with ``nvcc`` from
``DIR/mqtt_tpu_torch/csrc`` into this checkout's build directory, held
against the plain PyTorch version on every input before it is timed, and
timed as ``chip_smoke.py`` times a kernel (CUDA events over 20 calls).
Prints the card's name and power limit, then one line per shape. Exits
1 if a build fails or disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import os
import random
import subprocess
import sys

import numpy as np


def compare(torch, cs, against: list, iters: int = 20) -> None:
    """K4 and K1 built from this checkout's sources and from those of each
    checkout in ``against`` (for example a git archive of the parent
    commit), timed on one card in turns: K4 on synthetic cfgP-shaped
    tables (104,000 rules padded to 131,072, its 2,000 bit-op rules spread
    through the table or first in it with their cmask bits in order or at
    random; S = 1 and 2; B from 16 to 4096), K1 on cfg2's and cfg3's
    indexes at 300,000 subscriptions (B from 16 to 65,536). Every build's
    output is first held against the plain version (tolerance 0)."""
    from .ops import flat, kernels
    from .ops import predicates as pops

    dev = torch.device("cuda")
    trees = [("this tree", cs.HERE)] + [(d, d) for d in against]
    out_dir = kernels.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, root) in enumerate(trees):
        for src in ("predicates.cu", "flat_match.cu"):
            out = out_dir / f"{i}-{src}.so"
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out),
                   os.path.join(root, "mqtt_tpu_torch", "csrc", src)]
            procs.append((label, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)))
    libs = {}
    for label, src, out, proc in procs:
        text, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{label} {src}: nvcc exit {proc.returncode}\n{text}")
        lib = ctypes.CDLL(str(out))
        name = "pk_rules_eval" if src == "predicates.cu" else "fm_probe_ranges"
        getattr(lib, name).argtypes = kernels._SIGNATURES[src][name]
        libs[label, src] = getattr(lib, name)
    labels = [label for label, _ in trees]
    turns = labels + labels[::-1]
    stream = torch.cuda.current_stream().cuda_stream

    def rules(label, op, slot, thresh, cbit, f, m):
        out = torch.empty((f.shape[0], op.shape[0] // 32), dtype=torch.int32, device=dev)
        err = libs[label, "predicates.cu"](op.data_ptr(), slot.data_ptr(), thresh.data_ptr(), cbit.data_ptr(),
                                           op.shape[0], f.data_ptr(), f.shape[1], m.data_ptr(), m.shape[1],
                                           f.shape[0], out.data_ptr(), stream)
        cs.check(err == 0, f"{label} rules_eval failed to launch ({err})")
        return out

    def probe(label, table, kind, depth, mask, tokens, L):
        P = depth.shape[0]
        out = torch.empty((tokens.shape[0], 2 * P + 2), dtype=torch.int32, device=dev)
        err = libs[label, "flat_match.cu"](tokens.data_ptr(), tokens.shape[0], tokens.shape[1], L, table.data_ptr(),
                                           table.shape[0], kind.data_ptr(), depth.data_ptr(), mask.data_ptr(), P,
                                           out.data_ptr(), stream)
        cs.check(err == 0, f"{label} flat_probe_ranges failed to launch ({err})")
        return out

    def timed(what, fn, want, args):
        for label in labels:
            cs.check(torch.equal(fn(label, *args), want), f"{label} {what}: disagrees with the plain version")
        row = ", ".join(f"{label} {cs.event_ms(torch, lambda: fn(label, *args), iters):.4f}" for label in turns)
        cs.log(f"  {what}: {row} ms")

    g = np.random.default_rng(1)
    R, n_rules, n_bit, W, B = 131072, 104000, 2000, 63, 4096
    op = np.zeros(R, np.int32)
    op[:n_rules] = pops.OP_GT
    thresh = np.zeros(R, np.float32)
    thresh[:n_rules] = g.integers(0, 100, n_rules)
    bit_op = np.where(np.arange(n_bit) % 2 == 0, pops.OP_CONTAINS, pops.OP_EQS).astype(np.int32)
    spread, first = op.copy(), op.copy()
    spread[g.choice(n_rules, n_bit, replace=False)] = bit_op
    first[:n_bit] = bit_op

    def in_order(ops):
        cbit = np.zeros(R, np.int32)
        cbit[np.isin(ops, (pops.OP_CONTAINS, pops.OP_EQS))] = np.arange(n_bit)
        return cbit

    at_random = g.integers(0, 32 * W, R).astype(np.int32)
    F = {S: g.integers(0, 100, (B, S)).astype(np.float32) for S in (1, 2)}
    for f in F.values():
        f[g.random(f.shape) < 0.05] = np.nan
    M = g.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32).view(np.int32)
    cs.log(f"compare K4 (ms per call, {' / '.join(turns)}):")
    for what, ops, cbit in (("spread", spread, in_order(spread)), ("first, bits in order", first, in_order(first)),
                            ("first, bits at random", first, at_random)):
        for S in (1, 2):
            slot = g.integers(0, S, R).astype(np.int32)
            table = [torch.from_numpy(a).to(dev) for a in (ops, slot, thresh, cbit)]
            for b in (4096, 256, 128, 64, 16):
                f_t = torch.from_numpy(np.ascontiguousarray(F[S][:b])).to(dev)
                m_t = torch.from_numpy(np.ascontiguousarray(M[:b])).to(dev)
                timed(f"K4 bit-op rules {what}, S={S}, B={b}", rules, pops.rules_eval_plain(*table, f_t, m_t),
                      (*table, f_t, m_t))
    torch.cuda.empty_cache()
    cs.log(f"compare K1 (ms per call, {' / '.join(turns)}):")
    for name, build in (("cfg2", cs.build_cfg2), ("cfg3", cs.build_cfg3)):
        gc.disable()
        index, _, topic_gen = build(300_000, random.Random(2))
        fl = flat.build_flat_index(index, max_levels=8)
        gc.enable()
        arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
        for b in (16, 256, 4096, 65536):
            tokens = cs._tokens(torch, flat, [topic_gen() for _ in range(b)], fl, dev)
            timed(f"K1 {name} P={fl.num_patterns} B={b}", probe,
                  flat.flat_match_packed_plain(*arrays, tokens, fl.max_levels), (*arrays, tokens, fl.max_levels))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", required=True, metavar="DIR",
                    help="root of a checkout whose kernels to time beside this one's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    try:
        cs.phase_card(torch)
        compare(torch, cs, args.against)
    except cs.PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
