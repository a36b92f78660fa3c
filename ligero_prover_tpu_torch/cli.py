"""Command-line prove and verify, JSON-config compatible with the reference.

Usage (mirrors ``webgpu_prover`` / ``webgpu_verifier``):

    python -m ligero_prover_tpu_torch.cli prove  '<JSON>' [proof_file]
    python -m ligero_prover_tpu_torch.cli verify '<JSON>' [proof_file]

JSON fields (``src/webgpu_prover.cpp:88-159``): ``program`` (.wat/.wasm),
``packing`` (row size k; l = k-192, n = 4k), ``args`` (list of
{"str": ...} | {"i64": ...} | {"hex": ...}), ``private-indices`` (list of
arg indices marked secret), ``batch-rows`` (rows per device flush, ours),
``device`` (torch device, default ``"cuda"``; ours).  A ``"cuda"`` run
raises when no card is present: it never falls back to the CPU.  The
``shader-path`` / ``gpu-threads`` fields of the reference are accepted and
ignored.

Exit code is 0 on success (prove: self-check passed; verify: proof valid),
1 otherwise — matching the reference's programs.
"""

from __future__ import annotations

import hashlib
import json
import sys

from . import __version__
from .params import RowGeometry
from .utils.timer import show_timers
from .zkp import transcript


def parse_args_field(jconfig) -> list[bytes]:
    """Build the program argument vector (argv[0] = "Ligero\\0")."""
    input_args = [b"Ligero\x00"]
    for arg in jconfig.get("args", []):
        if "i64" in arg:
            v = int(arg["i64"])
            input_args.append((v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))
        elif "str" in arg:
            input_args.append(arg["str"].encode() + b"\x00")
        elif "hex" in arg:
            h = arg["hex"]
            if h.startswith("0x"):
                h = h[2:]
            if len(h) % 2:
                h = "0" + h
            input_args.append(bytes.fromhex(h))
        else:
            raise SystemExit(f"Error: Invalid args type: {arg}")
    return input_args


def load_config(jstr: str):
    jconfig = json.loads(jstr)
    k = jconfig.get("packing", RowGeometry().k)
    geometry = RowGeometry(k)
    input_args = parse_args_field(jconfig)
    private_indices = set(jconfig.get("private-indices", []))
    program_path = jconfig["program"]
    batch_rows = jconfig.get("batch-rows", 16)
    device = jconfig.get("device", "cuda")
    return (geometry, input_args, private_indices, program_path, batch_rows,
            device)


def make_program(program_path: str, input_args, private_indices):
    data = open(program_path, "rb").read()
    program_hash = hashlib.sha256(data).digest()
    if program_path.endswith((".wat", ".wast")):
        from .vm.wat import parse_wat
        module = parse_wat(data.decode())
    else:
        from .vm.wasm import parse_wasm
        module = parse_wasm(data)
    from .vm.run import run_program

    def program(zkctx):
        run_program(module, zkctx, input_args, private_indices)

    return program, program_hash


def cmd_prove(jstr: str, proof_file: str = "proof_data.gz") -> int:
    from .prover import prove
    geometry, input_args, private_indices, path, batch_rows, device = \
        load_config(jstr)
    print(f"packing: {geometry.l}, padding: {geometry.k}, "
          f"encoding: {geometry.n}")
    program, program_hash = make_program(path, input_args, private_indices)
    inst_hash = transcript.instance_hash(input_args, private_indices)

    res = prove(program, geometry=geometry, instance_hash=inst_hash,
                program_hash=program_hash, batch_rows=batch_rows,
                device=device)
    with open(proof_file, "wb") as f:
        f.write(res.proof)

    print(f"Number of linear constraints:  {res.num_linear}")
    print(f"Number of quadratic gates:     {res.num_quadratic}")
    print(f"Number of committed rows:      {res.num_rows}")
    print(f"Prover root: {res.root.hex()}")
    print(f"Validation of encoding:              {res.valid_code}")
    print(f"Validation of linear constraints:    {res.valid_linear}")
    print(f"Validation of quadratic constraints: {res.valid_quad}")
    print("------------------------------------------")
    print(f"Final prove result:                  {res.ok}")
    show_timers()
    return 0 if res.ok else 1


def cmd_verify(jstr: str, proof_file: str = "proof_data.gz") -> int:
    from .verifier import verify
    geometry, input_args, private_indices, path, batch_rows, device = \
        load_config(jstr)
    program, _ = make_program(path, input_args, private_indices)
    inst_hash = transcript.instance_hash(input_args, private_indices)

    blob = open(proof_file, "rb").read()
    v = verify(program, blob, geometry=geometry, instance_hash=inst_hash,
               batch_rows=batch_rows, device=device)
    print(f"Validating Merkle Tree Root:         {v.valid_merkle}")
    print(f"Validating Encoding Correctness:     {v.valid_code}")
    print(f"Validating Linear Constraints:       {v.valid_linear}")
    print(f"Validating Quadratic Constraints:    {v.valid_quad}")
    print(f"Validating Encoding Equality:        {v.code_equal}")
    print(f"Validating Linear Equality:          {v.linear_equal}")
    print(f"Validating Quadratic Equality:       {v.quad_equal}")
    print("-----------------------------------------")
    print(f"Final Verify Result:                 {v.ok}")
    show_timers()
    return 0 if v.ok else 1


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    from .utils.log import configure as _log_configure
    _log_configure()  # leveled diagnostics via LIGERO_LOG=debug|info|...
    print(f"ligero-prover-tpu-torch v{__version__}")
    if len(argv) < 2 or argv[0] not in ("prove", "verify"):
        print("usage: python -m ligero_prover_tpu_torch.cli "
              "{prove|verify} '<JSON>' [proof_file]", file=sys.stderr)
        return 2
    cmd, jstr = argv[0], argv[1]
    proof_file = argv[2] if len(argv) > 2 else "proof_data.gz"
    if cmd == "prove":
        return cmd_prove(jstr, proof_file)
    return cmd_verify(jstr, proof_file)


if __name__ == "__main__":
    raise SystemExit(main())
