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


# The port's edits in a copied module (its spans and counters of
# ``utils/timer.py``, the codec's packed vectors, the bit gadgets' slot
# commits): each edit is (the reference's text, the port's), and the rest
# must not drift.
SPAN_EDITS = {
    "vm/interpreter.py": [
        ("from ..zkp.backend import Managed, DecomposedBits, SIGN, UNSIGN\n",
         "from ..zkp.backend import Managed, DecomposedBits, SIGN, UNSIGN\n"
         "from ..utils.timer import span\n"),
        ("            mod.call(field)\n",
         '            with span("vm.hostcall"):\n'
         "                mod.call(field)\n"),
        # the per-bit and/or/xor as one gadget
        ("        out = []\n"
         "        for i in range(nb):\n"
         '            if kind == "and":\n'
         "                out.append(b.eval(x[i] & y[i]))\n"
         '            elif kind == "or":\n'
         "                out.append(b.eval(x[i] + y[i] - (x[i] & y[i])))\n"
         "            else:\n"
         "                out.append(b.bitwise_xor(x[i], y[i]))\n",
         "        out = b.bitwise(kind, x.bits, y.bits)\n"),
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
    # the counter of the witness elements each flushed row carries
    "zkp/witness.py": [
        ("from .csprng import MpzRandomEngine\n",
         "from .csprng import MpzRandomEngine\n"
         "from ..utils.timer import count\n"),
        ("        self.linear_counter += data_size\n",
         "        self.linear_counter += data_size\n"
         '        count("witness.elements", data_size)\n'),
        ("        self.quadratic_counter += data_size\n",
         "        self.quadratic_counter += data_size\n"
         '        count("witness.elements", 3 * data_size)\n'),
        ("from .csprng import MpzRandomEngine\n",
         "from .csprng import MpzRandomEngine, draw_ints\n"),
        # a fresh witness may be given its randomness
        ("    def acquire_witness(self, value: int = 0) -> LazyWitness:\n"
         "        if self._wit_pool:\n"
         "            w = self._wit_pool.pop()\n"
         "            w.random = 0\n",
         "    def acquire_witness(self, value: int = 0,\n"
         "                        random: int = 0) -> LazyWitness:\n"
         "        if self._wit_pool:\n"
         "            w = self._wit_pool.pop()\n"),
        ("        w.is_witness = True\n"
         "        w.value = value\n",
         "        w.is_witness = True\n"
         "        w.value = value\n"
         "        w.random = random\n"),
        # the bit gadgets' slot commits
        ("    def mark_ready(self, offset: int) -> bool:\n"
         "        self.ready[offset] = True\n"
         "        return all(self.ready)\n\n", ""),
        ("        if wit.slot is not None:\n"
         "            if wit.slot.mark_ready(wit.slot_offset):\n"
         "                self._commit_quadratic(wit.slot)\n",
         "        slot = wit.slot\n"
         "        if slot is not None:\n"
         "            ready = slot.ready\n"
         "            ready[wit.slot_offset] = True\n"
         "            if ready[0] and ready[1] and ready[2]:\n"
         "                self._commit_quadratic(slot)\n"),
        ("        if len(self.quadratic_val[0]) >= self.l:\n"
         "            self.process_reset_quadratic_rows()\n"
         "        for i in range(3):\n"
         "            ws = slot.witnesses[i]\n"
         "            self.quadratic_val[i].append(ws.value)\n"
         "            if self.policy.enable_linear_check:\n"
         "                self.quadratic_random[i].append(ws.random)\n"
         "            self.live_witnesses -= 1\n"
         "            ws.is_witness = False\n"
         "            self._wit_pool.append(ws)\n",
         "        qv = self.quadratic_val\n"
         "        if len(qv[0]) >= self.l:\n"
         "            self.process_reset_quadratic_rows()\n"
         "            qv = self.quadratic_val\n"
         "        a, b, c = slot.witnesses\n"
         "        qv[0].append(a.value)\n"
         "        qv[1].append(b.value)\n"
         "        qv[2].append(c.value)\n"
         "        if self.policy.enable_linear_check:\n"
         "            qr = self.quadratic_random\n"
         "            qr[0].append(a.random)\n"
         "            qr[1].append(b.random)\n"
         "            qr[2].append(c.random)\n"
         "        self.live_witnesses -= 3\n"
         "        a.is_witness = b.is_witness = c.is_witness = False\n"
         "        self._wit_pool += (a, b, c)\n"),
    ],
    # the bulk vectors as packed wire bytes (the helpers end the module)
    "zkp/proof.py": [
        ("    proof.encoded_code.values.extend(\n"
         "        np.asarray(code, np.uint32).reshape(-1).tolist())\n"
         "    proof.encoded_linear.values.extend(\n"
         "        np.asarray(linear, np.uint32).reshape(-1).tolist())\n"
         "    proof.encoded_quadratic.values.extend(\n"
         "        np.asarray(quad, np.uint32).reshape(-1).tolist())\n"
         "    proof.sampled_data.values.extend(\n"
         "        np.asarray(samplings, np.uint32).reshape(-1).tolist())\n",
         "    _load_packed(proof.encoded_code, code)\n"
         "    _load_packed(proof.encoded_linear, linear)\n"
         "    _load_packed(proof.encoded_quadratic, quad)\n"
         "    _load_packed(proof.sampled_data, samplings)\n"),
        ("        np.asarray(proof.encoded_code.values, np.uint32),\n"
         "        np.asarray(proof.encoded_linear.values, np.uint32),\n"
         "        np.asarray(proof.encoded_quadratic.values, np.uint32),\n"
         "        leaf_indices, siblings,\n"
         "        np.asarray(proof.sampled_data.values, np.uint32),\n",
         "        _read_packed(proof.encoded_code),\n"
         "        _read_packed(proof.encoded_linear),\n"
         "        _read_packed(proof.encoded_quadratic),\n"
         "        leaf_indices, siblings,\n"
         "        _read_packed(proof.sampled_data),\n"),
    ],
    "vm/hostmods/bn254fr.py": [
        # constrain_quadratic's release callback went (always the same)
        ("        self._m.constrain_quadratic(out, x, y,"
         " self._m.commit_release_witness)\n",
         "        self._m.constrain_quadratic(out, x, y)\n"),
        ("            self._m.constrain_quadratic(c_val.wit, a_val.wit,"
         " b_val.wit,\n"
         "                                        self._m.commit_release_witness)\n",
         "            self._m.constrain_quadratic(c_val.wit, a_val.wit,"
         " b_val.wit)\n"),
    ],
    "zkp/backend.py": [
        ("from .witness import WitnessManager, LazyWitness\n",
         "from .witness import (WitnessManager, LazyWitness,\n"
         "                      generate_randoms)\n"
         "from ..utils.timer import count\n"),
        # constrain_quadratic's release callback went (always the same)
        ("        z = m.acquire_witness(F.mulmod(x.val, y.val))\n"
         "        m.constrain_quadratic(z, x.wit, y.wit,"
         " m.commit_release_witness)\n",
         "        z = m.acquire_witness(F.mulmod(x.val, y.val))\n"
         "        m.constrain_quadratic(z, x.wit, y.wit)\n"),
        ("        z = m.acquire_witness(x.val & y.val)\n"
         "        m.constrain_quadratic(z, x.wit, y.wit,"
         " m.commit_release_witness)\n",
         "        z = m.acquire_witness(x.val & y.val)\n"
         "        m.constrain_quadratic(z, x.wit, y.wit)\n"),
        # the one-bit cases of Backend.bitwise
        ("        return self.eval(x + y - (x & y) * 2)\n",
         '        return self.bitwise("xor", [x], [y])[0]\n'),
        ("        return self.eval(~(x + y - (x & y) * 2))\n",
         '        return self.bitwise("xnor", [x], [y])[0]\n'),
    ],
}
# Methods of the port's own in a copied module, held against the reference
# by the test named beside them, cut from the comparison: per module, the
# methods rewritten (cut from both sides) and those added (the port's
# only); the rest must not drift.
REPLACED = {
    # the bit gadgets as straight-line witness-manager operations
    # (tests/test_secret_gadgets.py: every row equals the JAX front end's)
    "zkp/backend.py": (["constrain_bit", "bit_decompose", "bit_compose"],
                       ["bitwise"]),
    # the slot primitives they share with constrain_quadratic (the same)
    "zkp/witness.py": (["constrain_quadratic"],
                       ["join_or_clone", "clone_into"]),
}
# A copied module may end in code of the port's own, below this line.
PORT_PART = "\n\n# -- The port's "


def _cut(text: str, name: str) -> str:
    """`text` without the method `name`: from its ``def`` line up to the
    next line indented four spaces or less."""
    head = f"\n    def {name}("
    assert text.count(head) == 1, name
    start = text.index(head) + 1
    lines = text[start:].split("\n")
    end = next(i for i, line in enumerate(lines) if i and line.strip()
               and len(line) - len(line.lstrip()) <= 4)
    return text[:start] + "\n".join(lines[end:])


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_has_not_drifted(rel):
    ref = (REF / rel).read_text()
    want = re.sub(r"\bligero_prover_tpu\b", "ligero_prover_tpu_torch", ref)
    for old, new in SPAN_EDITS.get(rel, []):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    got = (PORT / rel).read_text().split(PORT_PART)[0]
    rewritten, added = REPLACED.get(rel, ([], []))
    for name in rewritten:
        want = _cut(want, name)
        got = _cut(got, name)
    for name in added:
        assert f"\n    def {name}(" not in want, name
        got = _cut(got, name)
    assert got == want


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
    if bad.search((ROOT / "chip_smoke.py").read_text()):
        hits.append("chip_smoke.py")
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
