"""The port's problem tables against the reference, and its import boundary.

The port keeps its own copies of `fpga/device.py` and `fpga/netlist.py`;
every array, scalar and content hash must agree with the reference byte
for byte.  Its copies of the reference's serving modules that need no JAX
equal the reference's files, but for the lines that import the reference
package, which import the port's module of the same name (and, in the
scheduler, the lines that add its `device` argument; in prewarm, the
module docstring).  Nothing in `src/repro_torch/` or `chip_smoke.py` may import JAX
or the reference package.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.fpga import device as rdev
from repro.fpga import netlist as rnet
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"])


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def test_device_list_matches_reference():
    assert tdev.list_devices() == rdev.list_devices()


@pytest.mark.parametrize("name", rdev.list_devices())
def test_make_problem_matches_reference(name):
    rd, td = rdev.get_device(name), tdev.get_device(name)
    _assert_same(rd, td, name)
    assert (td.signature, td.sibling_key) == (rd.signature, rd.sibling_key)
    rp, tp = rnet.make_problem(rd), tnet.make_problem(td)
    _assert_same(rp, tp, name)
    assert (tp.signature, tp.sibling_key) == (rp.signature, rp.sibling_key)
    assert tp.genotype_sizes() == rp.genotype_sizes()


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_neither_jax_nor_reference(rel):
    bad = [m for m in _imported_modules(ROOT / rel)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{rel} imports {bad}"


# port copy -> the number of its lines that import the reference package
COPIES = {"runtime/telemetry.py": 1, "serve/tracing.py": 0, "serve/api.py": 3,
          "serve/policy.py": 0, "serve/frontend.py": 4}


def _lines(package, rel, below_docstring=False):
    text = (ROOT / "src" / package / rel).read_text()
    if below_docstring:
        text = text[text.index("from __future__ import annotations"):]
    return text.splitlines(keepends=True)


def _assert_import_lines_only(ref, port, n_imports):
    assert len(port) == len(ref)
    differ = [(a, b) for a, b in zip(ref, port) if a != b]
    assert len(differ) == n_imports
    for a, b in differ:
        assert a.lstrip().startswith("from repro.")
        assert b == a.replace("from repro.", "from repro_torch.", 1)


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_modules_equal_the_reference(rel):
    _assert_import_lines_only(_lines("repro", rel), _lines("repro_torch", rel), COPIES[rel])


def test_prewarm_equals_the_reference_below_its_docstring():
    """The port's docstring says what a prewarm does without XLA; the code
    below it is the reference's but for its one import line."""
    rel = "serve/prewarm.py"
    _assert_import_lines_only(_lines("repro", rel, True), _lines("repro_torch", rel, True), 1)


def test_scheduler_differs_only_in_imports_and_its_device():
    """The scheduler is the reference's but for its import lines and the
    lines that add its `device` argument: each of those mentions `device`."""
    import difflib
    ref, port = _lines("repro", "serve/scheduler.py"), _lines("repro_torch", "serve/scheduler.py")
    imports = device_lines = 0
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(a=ref, b=port, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        assert tag in ("replace", "insert"), (tag, ref[i1:i2])
        old, new = ref[i1:i2], list(port[j1:j2])
        for a in old:
            b = a.replace("from repro.", "from repro_torch.", 1)
            if a.lstrip().startswith("from repro.") and b in new:
                new.remove(b)
                imports += 1
        assert all("device" in b for b in new), new
        non_import = [a for a in old if not a.lstrip().startswith("from repro.")]
        assert len(non_import) <= len(new), (non_import, new)
        device_lines += len(new)
    assert (imports, device_lines) == (12, 4)
