"""What the port's kernel build needs, checked without a compiler: an
installed copy ships every file the build reads, and every C entry point
gets its ctypes signature.
"""

import fnmatch
import re
import tomllib
from pathlib import Path

import pytest

from mcmda_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", build.SOURCES + build.HEADERS)
def test_package_data_ships_every_file_of_the_build(name):
    """``pyproject.toml``'s package data covers the sources and the headers
    ``build.build`` hashes and compiles."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        patterns = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "mcmda_tpu_torch"]
    assert (build.CSRC / name).is_file()
    rel = (build.CSRC / name).relative_to(
        Path(build.__file__).parent.parent).as_posix()
    assert any(fnmatch.fnmatch(rel, p) for p in patterns), (rel, patterns)


class _Symbol:
    argtypes = restype = None


class _FakeLib:
    """Stands in for a loaded library: hands out a symbol for any name and
    remembers which were asked for."""

    def __init__(self):
        self.symbols = {}

    def __getattr__(self, name):
        return self.symbols.setdefault(name, _Symbol())


def _entry_points(source):
    """``{name: number of parameters}`` of a source's ``extern "C"``
    functions."""
    text = (build.CSRC / source).read_text()
    return {m.group(1): m.group(2).count(",") + 1 for m in re.finditer(
        r'extern "C" int (\w+)\(([^)]*)\)', text)}


@pytest.mark.parametrize("source", build.SOURCES)
def test_every_entry_point_is_declared(source):
    """Each ``extern "C"`` function of a source gets argtypes with one
    entry per parameter (an undeclared pointer would be cut to 32 bits)."""
    entries = _entry_points(source)
    assert entries
    lib = build.declare(_FakeLib())
    assert set(entries) <= set(lib.symbols)
    for name, n_params in entries.items():
        assert len(lib.symbols[name].argtypes) == n_params, name
        assert lib.symbols[name].restype is not None


def test_nothing_is_declared_that_no_source_defines():
    """``declare`` would raise on a real library for a name it lacks."""
    defined = set().union(*(_entry_points(s) for s in build.SOURCES))
    assert set(build.declare(_FakeLib()).symbols) == defined
