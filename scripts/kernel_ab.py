#!/usr/bin/env python3
"""Time the K4 (ring_mul) and K5 (bit_decompose, msb) kernels of one
checkout of the port at the main path's shapes and at 2^20 elements.

    python3 scripts/kernel_ab.py [--root CHECKOUT] [--label NAME]

``--root`` is the root of the checkout whose ``moose_tpu_torch`` is
timed (default: this one), so an older commit unpacked beside this one
can be timed in the same run: run parent, change, change, parent and
compare within the run.  Each row holds the kernel against its plain
version word for word, and gives its median CUDA-event time for one
call after a warm-up (``ms``), its time per call over 20 calls between
one pair of events (``ms_back_to_back``) and the device time per call
under torch.profiler (``device_ms``, the summed durations of the kernels
the card ran over 10 calls).  K4's factor is materialised at the
shares' shape, which every version takes, and, where the checkout's
``ring_mul`` broadcasts it (``ring_mul_dims`` exists), also at its own
shape; beside them the device time of ``spmd.mul_public`` at the
logistic regression's shapes, copies included.  The last line is one JSON object with the rows and the
card's name and power limit.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    """This checkout's chip_smoke.py, by path (``--root`` may hold
    another)."""
    path = os.path.join(HERE, os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_row(torch, cs, kernel, plain, args, **fields):
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    equal, _ = cs.word_diff(torch, got, want)
    del got, want
    return dict(
        fields, equal=equal,
        ms=cs.cuda_time_ms(torch, lambda: kernel(*args), reps=5),
        ms_back_to_back=cs.back_to_back_ms(torch, lambda: kernel(*args)),
        device_ms=cs.device_time_ms(torch, lambda: kernel(*args)),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.join(HERE, os.pardir))
    parser.add_argument("--label", default="this checkout")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(opts.root))
    from moose_tpu_torch.native import build
    from moose_tpu_torch.native import ring_kernels as rk

    build.build_all(["ring_mul", "bits_adder"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    rows = []
    for n, width, modes in (
        (cs.PATH_N, 128, (False, True)),
        (cs.TRAIN_ROWS, 128, (False, True)),
        (cs.TRAIN_ROWS * cs.MLP_HIDDEN, 128, (False, True)),
        (cs.BIG_N, 128, (False, True)),
        (cs.PATH_N, 64, (False,)),
    ):
        x = cs.random_words(torch, gen, (3, 2, n), width)
        n_ands = rk.adder_bank_count(width)
        banks = torch.randint(0, 2, (n_ands, 3, width, n), generator=gen,
                              dtype=torch.uint8, device="cuda")
        for msb_only in modes:
            kernel, plain = ((rk.msb, rk.msb_plain) if msb_only
                             else (rk.bit_decompose, rk.bit_decompose_plain))
            bound_ms, _ = cs.bits_bound(n, width, msb_only, n_ands)
            rows.append(time_row(
                torch, cs, kernel, plain, (*x, width, banks),
                name="bits_adder", shape=f"(3,2,{n})", width=width,
                mode="msb" if msb_only else "bit_decompose",
                bound_ms=bound_ms,
            ))
        del x, banks
        torch.cuda.empty_cache()
    own_shape = (False, True) if hasattr(rk, "ring_mul_dims") else (False,)
    for shape, const, width in (
        ((3, 2, cs.PATH_N), (), 128),
        ((3, 2, 64, cs.PATH_N), (64, 1), 128),
        ((3, 2, cs.BIG_N), (), 128),
        ((3, 2, 64, cs.PATH_N), (64, 1), 64),
        ((3, 2, cs.BIG_N), (), 64),
    ):
        a = cs.random_words(torch, gen, shape, width)
        c = cs.random_words(torch, gen, const, width)
        n = math.prod(shape)
        for own in own_shape:
            b = c if own else tuple(
                None if t is None else t.expand(shape).contiguous()
                for t in c)
            how = "own shape" if own else "materialised"
            row = time_row(
                torch, cs, rk.ring_mul, rk.ring_mul_plain, (*a, *b, width),
                name="ring_mul", shape=f"{shape} x {how} {const}",
                width=width,
                bound_ms=cs.ring_mul_bound(n, width, b[0].numel())[0],
            )
            if width == 64:
                def library():  # int64 multiplication wraps: ring64's product
                    return torch.mul(a[0], b[0])
                row["library_ms_back_to_back"] = cs.back_to_back_ms(
                    torch, library)
                row["library_device_ms"] = cs.device_time_ms(torch, library)
            rows.append(row)
    # spmd.mul_public as the path calls it, the constant at its own shape:
    # its device time whatever kernels the checkout runs for it (the
    # broadcast copies where it materialises the constant)
    from moose_tpu_torch.parallel import spmd

    for shape, const in (
        ((3, 2, cs.PATH_N, 1), ()),
        ((3, 2, 64, cs.PATH_N, 1), (64, 1, 1)),
        ((3, 2, 7, cs.PATH_N, 1), (7, 1, 1)),
    ):
        x = spmd.SpmdRep(*cs.random_words(torch, gen, shape, 128), 128)
        c = cs.random_words(torch, gen, const, 128)
        got = spmd.mul_public(x, *c)
        equal, _ = cs.word_diff(torch, (got.lo, got.hi),
                                rk.ring_mul_plain(x.lo, x.hi, *c, 128))
        rows.append(dict(
            name="mul_public", shape=f"{shape} x {const}", width=128,
            equal=equal,
            device_ms=cs.device_time_ms(
                torch, lambda: spmd.mul_public(x, *c)),
        ))
    smi = cs.nvidia_smi_line()
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps({"label": opts.label, "card": smi, "rows": rows}))
    return 0 if all(row["equal"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
