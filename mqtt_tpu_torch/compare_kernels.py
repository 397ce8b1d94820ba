"""Time the kernels built from this checkout's sources against the same
kernels built from other checkouts (for example a git archive of the
parent commit), on one card, in turns: K4 ``rules_eval``, K1
``flat_probe_ranges`` and K2 ``flat_match_compact``, and K8
``sharded_step``, K7 ``flat_match_slots`` and K9 ``tile_compact``.

    python3 -m mqtt_tpu_torch.compare_kernels --against DIR [--against DIR2] [--kernels K1-K2-K4 K7-K9]

Run from the root of a checkout, beside ``chip_smoke.py``, whose table
builders and timing it uses. Each build is compiled with ``nvcc`` from
``DIR/mqtt_tpu_torch/csrc`` into this checkout's build directory, held
against the plain PyTorch version on every input before it is timed, and
timed as ``chip_smoke.py`` times a kernel (CUDA events over 20 calls), each
build as its own tree launches it. Prints the card's name and power limit,
then one line per shape. Exits 1 if a build fails or disagrees with the
plain version.
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


GROUPS = ("K1-K2-K4", "K7-K9")
_SOURCES = {"K1-K2-K4": ("predicates.cu", "flat_match.cu"), "K7-K9": ("sharded.cu",)}


def build(torch, cs, against: list, sources) -> tuple:
    """Compile ``sources`` from this checkout and from each checkout in
    ``against``, one ``nvcc`` each, all started together; returns the
    labels and ``{(label, source): ctypes library}``."""
    from .ops import kernels

    trees = [("this tree", cs.HERE)] + [(d, d) for d in against]
    out_dir = kernels.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, root) in enumerate(trees):
        for src in sources:
            out = out_dir / f"{i}-{src}.so"
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out),
                   os.path.join(root, "mqtt_tpu_torch", "csrc", src)]
            procs.append((label, src, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                            text=True)))
    libs = {}
    for label, src, out, proc in procs:
        text, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{label} {src}: nvcc exit {proc.returncode}\n{text}")
        libs[label, src] = ctypes.CDLL(str(out))
    return [label for label, _ in trees], libs


def _timer(torch, cs, labels: list, iters: int):
    """``timed(what, fn, want, args)``: each label's ``fn(label, *args)``
    held against ``want`` (a tensor or a tuple of them, tolerance 0), then
    timed in turns (each label, then each again in reverse order)."""
    turns = labels + labels[::-1]

    def equal(got, want):
        if isinstance(want, torch.Tensor):
            return torch.equal(got, want)
        return all(torch.equal(g, w) for g, w in zip(got, want))

    def timed(what, fn, want, args):
        for label in labels:
            cs.check(equal(fn(label, *args), want), f"{label} {what}: disagrees with the plain version")
        row = ", ".join(f"{label} {cs.event_ms(torch, lambda: fn(label, *args), iters):.4f}" for label in turns)
        cs.log(f"  {what}: {row} ms")

    return timed


def compare(torch, cs, against: list, iters: int = 20) -> None:
    """K4, K1 and K2 built from this checkout's sources and from those of
    each checkout in ``against`` (for example a git archive of the parent
    commit), timed on one card in turns: K4 on synthetic cfgP-shaped
    tables (104,000 rules padded to 131,072, its 2,000 bit-op rules spread
    through the table or first in it with their cmask bits in order or at
    random; S = 1 and 2; B from 16 to 4096), K1 on cfg2's and cfg3's
    indexes at 300,000 subscriptions (B from 16 to 65,536), K2 on the same
    batches at 1.5 times their hits. Every build's output is first held
    against the plain version (tolerance 0)."""
    from .ops import flat, kernels
    from .ops import predicates as pops

    dev = torch.device("cuda")
    labels, built = build(torch, cs, against, _SOURCES["K1-K2-K4"])
    libs = {}
    for (label, src), lib in built.items():
        names = ("pk_rules_eval",) if src == "predicates.cu" else ("fm_probe_ranges", "fm_match_compact")
        for name in names:
            getattr(lib, name).argtypes = kernels._SIGNATURES[src][name]
            libs[label, name] = getattr(lib, name)
    turns = labels + labels[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    # K2's zeroed scratch per build and layout (kernels._compact_scratch_for), and last epoch per build
    compact_scratch: dict = {}
    compact_epoch = dict.fromkeys(labels, 0)

    def rules(label, op, slot, thresh, cbit, f, m):
        out = torch.empty((f.shape[0], op.shape[0] // 32), dtype=torch.int32, device=dev)
        err = libs[label, "pk_rules_eval"](op.data_ptr(), slot.data_ptr(), thresh.data_ptr(), cbit.data_ptr(),
                                           op.shape[0], f.data_ptr(), f.shape[1], m.data_ptr(), m.shape[1],
                                           f.shape[0], out.data_ptr(), stream)
        cs.check(err == 0, f"{label} rules_eval failed to launch ({err})")
        return out

    def probe(label, table, kind, depth, mask, tokens, L):
        P = depth.shape[0]
        out = torch.empty((tokens.shape[0], 2 * P + 2), dtype=torch.int32, device=dev)
        err = libs[label, "fm_probe_ranges"](tokens.data_ptr(), tokens.shape[0], tokens.shape[1], L, table.data_ptr(),
                                           table.shape[0], kind.data_ptr(), depth.data_ptr(), mask.data_ptr(), P,
                                           out.data_ptr(), stream)
        cs.check(err == 0, f"{label} flat_probe_ranges failed to launch ({err})")
        return out

    def compact(label, table, kind, depth, mask, tokens, L, capacity):
        B, P = tokens.shape[0], depth.shape[0]
        warps = kernels._compact_warps(P, B)
        need = 4 + 4 * -(-B // (warps * (32 // min(P, 32))))
        scratch = compact_scratch.get((label, need))
        if scratch is None:
            scratch = compact_scratch[label, need] = torch.zeros((need,), dtype=torch.int32, device=dev)
        compact_epoch[label] = epoch = compact_epoch[label] % kernels._EPOCH_MASK + 1
        out = torch.empty((2 + 2 * B + capacity,), dtype=torch.int32, device=dev)
        err = libs[label, "fm_match_compact"](tokens.data_ptr(), B, tokens.shape[1], L, table.data_ptr(),
                                              table.shape[0], kind.data_ptr(), depth.data_ptr(), mask.data_ptr(),
                                              P, capacity, out.data_ptr(), scratch.data_ptr(), warps, epoch,
                                              stream)
        cs.check(err == 0, f"{label} flat_match_compact failed to launch ({err})")
        return out

    timed = _timer(torch, cs, labels, iters)
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
    for name, make in (("cfg2", cs.build_cfg2), ("cfg3", cs.build_cfg3)):
        gc.disable()
        index, _, topic_gen = make(300_000, random.Random(2))
        fl = flat.build_flat_index(index, max_levels=8)
        gc.enable()
        arrays = flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth, fl.pat_mask, dev)
        for b in (16, 256, 4096, 65536):
            tokens = cs._tokens(torch, flat, [topic_gen() for _ in range(b)], fl, dev)
            want = flat.flat_match_packed_plain(*arrays, tokens, fl.max_levels)
            timed(f"K1 {name} P={fl.num_patterns} B={b}", probe, want, (*arrays, tokens, fl.max_levels))
            cap = max(1, int(want[:, 2 * fl.num_patterns].sum()) * 3 // 2)
            timed(f"K2 {name} P={fl.num_patterns} B={b} capacity={cap}", compact,
                  flat.flat_match_compact_plain(*arrays, tokens, fl.max_levels, cap),
                  (*arrays, tokens, fl.max_levels, cap))


def _sharded_abi(lib) -> bool:
    """Whether a build of ``sharded.cu`` takes the tile dimension (one K8
    launch over every tile, K9 with a look-back scratch and an epoch), as
    this tree's does; older builds launch K8 once per tile and give K9 one
    int of scratch per segment."""
    try:
        lib.sh_tile_compact_scratch
    except AttributeError:
        return False
    return True


def compare_sharded(torch, cs, against: list, iters: int = 20) -> None:
    """K8, K7 and K9 built from this checkout's ``sharded.cu`` and from each
    checkout in ``against``, timed on one card in turns, each build as its
    tree launches it (a build without the tile dimension: one K8 launch per
    tile). K8 over the 4 stacked shards of cfg2's and cfg3's indexes at
    300,000 subscriptions on a mesh of 8 positions of the card (2 tiles x 4
    shards, K = 64), K7 on the whole index (S = 1), B from 64 to 65,536; K9
    on K8's output at the capacity the path's policy picks for the batch's
    hits, at one below the tiles' hits, and at 32 slots a topic (a long -1
    tail, as the path's capacity at 1M subscriptions gives it). Every
    build's output is first
    held against the plain version (tolerance 0)."""
    from .ops import flat, kernels
    from .ops.matcher import pick_compact_capacity
    from .parallel import ShardedTorchMatcher, make_mesh
    from .parallel import sharded

    dev = torch.device("cuda")
    labels, built = build(torch, cs, against, _SOURCES["K7-K9"])
    sigs = kernels._SIGNATURES["sharded.cu"]
    new = {}
    for (label, _src), lib in built.items():
        new[label] = _sharded_abi(lib)
        if new[label]:
            for name in ("sh_match_slots", "sh_tile_compact", "sh_tile_compact_scratch"):
                getattr(lib, name).argtypes = sigs[name]
            lib.sh_tile_compact_scratch.restype = ctypes.c_longlong
        else:
            # the parent's interface: K8 per tile, K9's scratch one int per segment
            lib.sh_match_slots.argtypes = sigs["sh_match_slots"][:1] + sigs["sh_match_slots"][2:]
            lib.sh_tile_compact.argtypes = sigs["sh_tile_compact"][:10] + sigs["sh_tile_compact"][12:]
    libs = {label: lib for (label, _src), lib in built.items()}
    turns = labels + labels[::-1]
    stream = torch.cuda.current_stream().cuda_stream
    epochs = {label: 0 for label in labels}

    def slots(label, tables, kind, depth, mask, tokens, L, T, K):
        """K8 (or K7 where S = 1) into fresh [T, S, bl, K] outputs."""
        S, P, bl = tables.shape[0], depth.shape[1], tokens.shape[0] // T
        out = torch.empty((T, S, bl, K), dtype=torch.int32, device=dev)
        tot = torch.empty((T, S, bl), dtype=torch.int32, device=dev)
        ovf = torch.empty((T, S, bl), dtype=torch.bool, device=dev)
        lib = libs[label]
        head = (tables.data_ptr(), S, tables.shape[1], kind.data_ptr(), depth.data_ptr(), mask.data_ptr(), P, K, 0)
        if new[label]:
            err = lib.sh_match_slots(tokens.data_ptr(), T, bl, tokens.shape[1], L, *head, out.data_ptr(),
                                     tot.data_ptr(), ovf.data_ptr(), stream)
        else:
            err = 0
            for t in range(T):
                err |= lib.sh_match_slots(tokens[t * bl :].data_ptr(), bl, tokens.shape[1], L, *head,
                                          out[t].data_ptr(), tot[t].data_ptr(), ovf[t].data_ptr(), stream)
        cs.check(err == 0, f"{label} match_slots failed to launch ({err})")
        return out, tot, ovf

    scratch = {}

    def compact(label, out, tot, ovf, cap):
        T, S, bl, K = out.shape
        rows = torch.empty((T, 2 + 2 * bl + 2 * cap), dtype=torch.int32, device=dev)
        lib = libs[label]
        args = (out.data_ptr(), tot.data_ptr(), ovf.data_ptr(), T, S, bl, K, cap, rows.data_ptr())
        if new[label]:
            # counters laid out for T tiles; a larger need takes a fresh zeroed buffer
            need = max(1, lib.sh_tile_compact_scratch(T, S, bl, T))
            if scratch.get(label) is None or scratch[label].numel() < need:
                scratch[label] = torch.zeros((need,), dtype=torch.int32, device=dev)
            epochs[label] = epochs[label] % ((1 << 31) - 1) + 1
            err = lib.sh_tile_compact(*args, scratch[label].data_ptr(), T, epochs[label], stream)
        else:
            tmp = torch.empty((T * S * bl,), dtype=torch.int32, device=dev)
            err = lib.sh_tile_compact(*args, tmp.data_ptr(), stream)
        cs.check(err == 0, f"{label} tile_compact failed to launch ({err})")
        return rows

    timed = _timer(torch, cs, labels, iters)
    cs.log(f"compare K8, K7, K9 (ms per call, {' / '.join(turns)}):")
    for name, make in (("cfg2", cs.build_cfg2), ("cfg3", cs.build_cfg3)):
        gc.disable()
        index, _, topic_gen = make(300_000, random.Random(2))
        fl = flat.build_flat_index(index, max_levels=8)
        m = ShardedTorchMatcher(index, mesh=make_mesh([dev] * 8), max_levels=8)
        m.rebuild()
        gc.enable()
        try:
            (stack,) = m._compiled[0].values()
            _, _, salt = m._compiled
            single = [a[None] for a in flat.device_index_from_numpy(fl.table, fl.pat_kind, fl.pat_depth,
                                                                    fl.pat_mask, dev)]
            S, T, K = m.n_shards, m.n_batch, m.out_slots
            for b in (64, 256, 4096, 65536):
                topics = [topic_gen() for _ in range(b)]
                tokens = cs._tokens(torch, flat, topics, m._flats[0], dev)
                want = [torch.empty(sh, dtype=dt, device=dev) for sh, dt in (
                    ((T, S, b // T, K), torch.int32), ((T, S, b // T), torch.int32), ((T, S, b // T), torch.bool))]
                sharded.sharded_step_plain(*stack, tokens, max_levels=8, out=want[0], totals=want[1],
                                           overflow=want[2])
                timed(f"K8 {name} S={S} tiles={T} P={stack[1].shape[1]} B={b}", slots, tuple(want),
                      (*stack, tokens, 8, T, K))
                tok1 = cs._tokens(torch, flat, topics, fl, dev)
                core = flat.flat_match_core_plain(*(a[0] for a in single), tok1, 8, K)
                timed(f"K7 {name} S=1 P={fl.num_patterns} B={b}", slots,
                      (core[0][None, None], core[1][None, None], core[2][None, None]), (*single, tok1, 8, 1, K))
                n_hits = int(want[1].clamp(max=K).sum())
                cap = max(16, pick_compact_capacity(0, max(1.0, n_hits / b), b, b * S * K, {}) // T)
                small = max(1, min(int(want[1][t].clamp(max=K).sum()) for t in range(T)) // 2)
                heavy = max(cap, 32 * (b // T))
                for c, what in ((cap, "the policy's capacity"), (small, "below the hits"),
                                (heavy, "32 slots a topic: a long -1 tail")):
                    timed(f"K9 {name} T={T} S={S} bl={b // T} cap_local={c} ({what}, hits {n_hits})", compact,
                          sharded.tile_compact_plain(*want, c), (*want, c))
        finally:
            m.close()
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", required=True, metavar="DIR",
                    help="root of a checkout whose kernels to time beside this one's")
    ap.add_argument("--kernels", nargs="+", choices=GROUPS, default=list(GROUPS),
                    help="which kernels to compare (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    try:
        cs.phase_card(torch)
        if "K1-K2-K4" in args.kernels:
            compare(torch, cs, args.against)
        if "K7-K9" in args.kernels:
            compare_sharded(torch, cs, args.against)
    except cs.PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
