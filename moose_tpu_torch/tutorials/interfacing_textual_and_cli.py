"""Advanced usage: interfacing Python computations with the CLI tools.

The port's program of ``tutorials/interfacing_textual_and_cli.py`` (the
reference tutorial ``interfacing-moose-with-pymoose.ipynb``): a
``@pm.computation`` is traced, serialized, compiled by the elk compiler,
written out in the line-per-op TEXTUAL format (``.moose``), inspected
with ``elk stats``, and executed from the file by ``dasher`` (the
single-process all-roles simulator): the workflow for driving the
runtime without Python in the loop.  dasher runs every role on the card
unless ``--device cpu``.

    python -m moose_tpu_torch.tutorials.interfacing_textual_and_cli
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

import moose_tpu_torch as pm
from moose_tpu_torch import elk_compiler, serde, textual
from moose_tpu_torch.distributed.spawn import worker_env
from moose_tpu_torch.edsl import tracer
from moose_tpu_torch.examples import parse_args

FIXED = pm.fixed(24, 40)
LIMIT = 1e-3

player0 = pm.host_placement("player0")
player1 = pm.host_placement("player1")
player2 = pm.host_placement("player2")
repl = pm.replicated_placement("replicated", players=[player0, player1, player2])


@pm.computation
def my_computation():
    # (Constants embedded like this are NOT secret: they live in the
    # graph in plaintext.  Pedagogical example, as in the reference.)
    with player0:
        x = pm.constant(np.array([1.0, 2.0, 3.0]), dtype=pm.float64)
        x = pm.cast(x, dtype=FIXED)
    with player1:
        y = pm.constant(np.array([4.0, 5.0, 6.0]), dtype=pm.float64)
        y = pm.cast(y, dtype=FIXED)
    with repl:
        z = pm.dot(x, y)
    with player2:
        out = pm.cast(z, dtype=pm.float64)
    return out


def comp_to_moose(abstract_comp, filepath):
    """Trace -> msgpack -> elk compile (no passes: keep it logical) ->
    textual form, written to ``filepath`` (the reference's
    ``comp_to_moose`` helper)."""
    traced = tracer.trace(abstract_comp)
    comp_bin = serde.serialize_computation(traced)
    compiled_bin = elk_compiler.compile_computation(comp_bin, passes=[])
    comp = serde.deserialize_computation(compiled_bin)
    text = textual.to_textual(comp)
    pathlib.Path(filepath).write_text(text)
    return text


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    args = parse_args(parser, argv)

    with tempfile.TemporaryDirectory() as tmp:
        moose_file = pathlib.Path(tmp) / "dotprod.moose"

        # 1. Python -> textual .moose file
        text = comp_to_moose(my_computation, moose_file)
        print("-- first 5 lines of the textual computation --")
        print("\n".join(text.splitlines()[:5]))

        # the port's checkout first on PYTHONPATH; dasher runs real
        # role-filtered workers, which refuse to derive share masks from
        # the non-cryptographic default PRF
        env = worker_env()

        # 2. Inspect with `elk stats` (op histogram)
        hist = subprocess.run(
            [sys.executable, "-m", "moose_tpu_torch.bin.elk", "stats",
             "op_hist", str(moose_file)],
            capture_output=True, text=True, check=True, env=env,
        )
        print("-- elk stats op_hist --")
        print(hist.stdout.strip())

        # 3. Fully compile: lower the replicated ops to host ops and
        #    insert Send/Recv on cross-host edges (with no --passes, elk
        #    only converts formats, the reference elk's contract)
        compiled_file = pathlib.Path(tmp) / "dotprod-compiled.moose"
        subprocess.run(
            [sys.executable, "-m", "moose_tpu_torch.bin.elk", "compile",
             str(moose_file), "-o", str(compiled_file), "--passes",
             "typing,lowering,prune,networking,toposort"],
            check=True, env=env,
        )
        n_lowered = len(compiled_file.read_text().splitlines())
        print(f"compiled graph: {n_lowered} textual ops")
        if not n_lowered > 50:
            raise AssertionError("lowering should expand the secure dot")

        # 4. Execute the FILE with dasher (all roles in one process)
        run = subprocess.run(
            [sys.executable, "-m", "moose_tpu_torch.bin.dasher",
             str(moose_file), "--device", args.device],
            capture_output=True, text=True, check=True, env=env,
        )
        print("-- dasher output --")
        print(run.stdout.strip())

        out_line = [
            ln for ln in run.stdout.splitlines() if "output" in ln
        ][-1]
        value = float(json.loads(out_line.split(":", 1)[1])
                      if out_line.strip().startswith("{")
                      else out_line.split()[-1])
        expected = float(np.dot([1.0, 2.0, 3.0], [4.0, 5.0, 6.0]))
        if not abs(value - expected) < LIMIT:
            raise AssertionError((value, expected))
        print(f"OK — dasher computed {value} == {expected}")
        return value


if __name__ == "__main__":
    main()
