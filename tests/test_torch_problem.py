"""The port's problem tables against the reference, and its import boundary.

The port keeps its own copies of `fpga/device.py` and `fpga/netlist.py`;
every array, scalar and content hash must agree with the reference byte
for byte.  Nothing in `src/repro_torch/` or `chip_smoke.py` may import JAX
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
