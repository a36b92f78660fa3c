"""Port hygiene: the copied framework-free modules have not drifted from
the JAX package, the port runs with JAX unimportable, the JSON CLI keeps
its 0/1 exit contract and refuses a missing card, and ``chip_smoke.py``
fails (printing no result) where there is no CUDA device."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ligero_prover_tpu_torch import cli

import _torch_helpers  # noqa: F401  (thread count)

ROOT = Path(__file__).resolve().parent.parent
REF, PORT = ROOT / "ligero_prover_tpu", ROOT / "ligero_prover_tpu_torch"

COPIED = [
    "field/__init__.py", "field/bn254.py", "field/limbs.py",
    "field/golden.py", "params.py", "utils/__init__.py", "utils/log.py",
    "utils/timer.py", "proto/__init__.py", "proto/ligero_common.proto",
    "proto/ligero_proof.proto", "proto/ligero_common_pb2.py",
    "proto/ligero_proof_pb2.py", "vm/__init__.py", "vm/values.py",
    "vm/wat.py", "vm/wasm.py", "vm/module.py", "vm/interpreter.py",
    "vm/run.py", "vm/hostmods/__init__.py", "vm/hostmods/env.py",
    "vm/hostmods/wasi.py", "vm/hostmods/bn254fr.py",
    "vm/hostmods/uint256.py", "vm/hostmods/ecc.py", "zkp/__init__.py",
    "zkp/witness.py", "zkp/backend.py", "zkp/csprng.py", "zkp/sampling.py",
    "zkp/merkle.py", "zkp/transcript.py", "zkp/proof.py",
]


# The port's spans (``utils/timer.py``) in a copied module: each edit is
# (the reference's text, the port's), and the rest must not drift.
SPAN_EDITS = {
    "vm/interpreter.py": [
        ("from ..zkp.backend import Managed, DecomposedBits, SIGN, UNSIGN\n",
         "from ..zkp.backend import Managed, DecomposedBits, SIGN, UNSIGN\n"
         "from ..utils.timer import span\n"),
        ("            mod.call(field)\n",
         '            with span("vm.hostcall"):\n'
         "                mod.call(field)\n"),
    ],
    "utils/timer.py": [
        ('printed with show_timers()."""\n',
         "printed with show_timers();\n"
         'and, below, the port\'s spans and counters."""\n'),
        ("import time\nfrom contextlib import contextmanager\n",
         "import contextlib\nimport functools\nimport time\n"
         "from contextlib import contextmanager\n\n"
         "from torch.autograd import profiler as _profiler\n"),
        ("        yield\n",
         "        with span(name):\n"
         "            yield\n"),
        ("    _STACK.clear()\n",
         "    _STACK.clear()\n"
         "    _clear_spans()\n"),
    ],
}
# A copied module may end in code of the port's own, below this line.
PORT_PART = "\n\n# -- The port's spans and counters "


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    ref = (REF / rel).read_text()
    want = re.sub(r"\bligero_prover_tpu\b", "ligero_prover_tpu_torch", ref)
    for old, new in SPAN_EDITS.get(rel, []):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (PORT / rel).read_text().split(PORT_PART)[0] == want


# pure-Python table functions of the int8 engine, copied function by
# function (the reference module imports jax at its top)
MXU_TABLE_FUNCS = ["_signed_digits", "_toeplitz_digits", "_split_rc",
                "_pow_table", "_dft_matrix", "_twiddle_mont_planar"]


@pytest.mark.parametrize("name", MXU_TABLE_FUNCS)
def test_copied_table_function_has_not_drifted(name):
    import inspect
    from ligero_prover_tpu.ops import mxu_ntt as ref
    from ligero_prover_tpu_torch.ops import mxu_ntt as port
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name))


@pytest.mark.parametrize("rel", ["ops/mxu_ntt.py", "ops/mxu_renorm.py"])
def test_engine_modules_import_no_jax(rel):
    text = (PORT / rel).read_text()
    assert not re.search(r"^\s*(import|from) (jax|ligero_prover_tpu)\b",
                         text, re.M)
    assert re.search(r"^import torch$", text, re.M)


def test_port_sources_import_no_jax():
    bad = re.compile(r"^\s*(import|from) (jax|ligero_prover_tpu)\b", re.M)
    hits = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
            if bad.search(p.read_text())]
    hits += [script for script in ("chip_smoke.py", "profile_prove.py")
             if bad.search((ROOT / script).read_text())]
    assert hits == []


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["ligero_prover_tpu"] = None
import torch
torch.set_num_threads(2)
import chip_smoke
from ligero_prover_tpu_torch import cli, convert, kernels
from ligero_prover_tpu_torch.params import RowGeometry
from ligero_prover_tpu_torch.prover import prove
from ligero_prover_tpu_torch.verifier import verify
from ligero_prover_tpu_torch.vm.run import make_wat_program
prog = make_wat_program(chip_smoke.make_wat(2), [], set())
geo = RowGeometry(256)
res = prove(prog, geometry=geo, encoding_seed=bytes(32), device="cpu")
assert res.ok
assert verify(prog, res.proof, geometry=geo, device="cpu").ok
from ligero_prover_tpu_torch.ops import mxu_ntt, mxu_renorm, ntt
ntt.USE_MXU = True
mxu = prove(prog, geometry=geo, encoding_seed=bytes(32), device="cpu")
assert mxu.ok and mxu_renorm.PLAIN_CALLS["renorm_final"]["cpu"] > 0
assert mxu.root == res.root
assert "jax" not in [m.split(".")[0] for m in sys.modules
                     if sys.modules[m] is not None]
print("NO_JAX_OK")
"""


def test_port_proves_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


def test_cli_exit_codes(tmp_path, capsys):
    wat = tmp_path / "guest.wat"
    from chip_smoke import make_wat
    wat.write_text(make_wat(2))
    proof = tmp_path / "proof.gz"
    conf = {"program": str(wat), "packing": 256, "batch-rows": 8,
            "device": "cpu"}
    assert cli.main(["prove", json.dumps(conf), str(proof)]) == 0
    assert cli.main(["verify", json.dumps(conf), str(proof)]) == 0
    # the same proof against a different program must be rejected
    other = tmp_path / "other.wat"
    other.write_text(make_wat(3))
    bad = dict(conf, program=str(other))
    assert cli.main(["verify", json.dumps(bad), str(proof)]) == 1
    assert "Final Verify Result:                 False" in \
        capsys.readouterr().out


def test_cli_default_device_is_cuda_and_never_falls_back(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wat = tmp_path / "guest.wat"
    from chip_smoke import make_wat
    wat.write_text(make_wat(2))
    conf = {"program": str(wat), "packing": 256}
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["prove", json.dumps(conf), str(tmp_path / "p.gz")])


def test_chip_smoke_guest_is_the_bench_guest():
    from bench.e2e_prove import make_wat as bench_wat
    from chip_smoke import make_wat
    assert make_wat(400) == bench_wat(400)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    import torch
    if torch.cuda.is_available() and not alone:
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
