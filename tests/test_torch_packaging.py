"""The port's packaging metadata (`vae_posterior_consistency_tpu_torch/
pyproject.toml`) against its layout: every subpackage listed, the console
scripts resolve to callables, the kernels' and the data plane's sources
ship with the package, no dependency names JAX, and the builds go under
the user's cache where the checkout is read-only."""

import importlib
import os
import pathlib
import tomllib

import pytest

from vae_posterior_consistency_tpu_torch.data import native_io
from vae_posterior_consistency_tpu_torch.ops import _build

PORT = pathlib.Path(__file__).resolve().parents[1] / \
    "vae_posterior_consistency_tpu_torch"
PKG = PORT.name


@pytest.fixture(scope="module")
def pyproject():
    with open(PORT / "pyproject.toml", "rb") as fh:
        return tomllib.load(fh)


def test_every_subpackage_is_listed_and_maps_to_its_directory(pyproject):
    setup = pyproject["tool"]["setuptools"]
    assert setup["package-dir"] == {PKG: "."}
    assert "pytest" not in pyproject.get("tool", {})
    listed = set(setup["packages"])
    subs = {f"{PKG}.{d.name}" for d in PORT.iterdir()
            if (d / "__init__.py").is_file()}
    assert {f"{PKG}.tools", f"{PKG}.examples"} <= subs
    assert listed == subs | {PKG}
    for pkg in listed:
        parts = pkg.split(".")[1:]
        assert (PORT.joinpath(*parts) / "__init__.py").is_file(), pkg


def test_the_console_scripts_import_and_are_callable(pyproject):
    scripts = pyproject["project"]["scripts"]
    assert set(scripts) == {"vpc-torch-impute", "vpc-torch-impute-mnar",
                            "vpc-torch-active-learning", "vpc-torch-ais"}
    for target in scripts.values():
        modpath, func = target.split(":")
        assert modpath.startswith(f"{PKG}.experiment_main."), target
        assert callable(getattr(importlib.import_module(modpath), func))


def test_the_sources_ship_and_no_dependency_names_jax(pyproject):
    globs = pyproject["tool"]["setuptools"]["package-data"][PKG]
    shipped = {p for g in globs for p in PORT.glob(g)}
    sources = set((PORT / "csrc").glob("*.cu")) | set(
        (PORT / "csrc").glob("*.cpp"))
    assert sources and sources <= shipped
    assert set(_build.CSRC.glob("*.cu*")) <= shipped
    assert native_io.SOURCE in shipped
    deps = pyproject["project"]["dependencies"]
    assert sorted(deps) == ["numpy", "torch"]
    assert not any("jax" in d or "optax" in d for d in deps)


@pytest.mark.parametrize("name", ["vpc_torch_kernels", "vpc_torch_io"])
def test_the_build_falls_back_to_the_cache_when_read_only(
        tmp_path, monkeypatch, name):
    """`build/<name>` in a writable checkout (before and after `build/`
    exists), `~/.cache/<name>` where it may not be written: the check is
    `os.access`, patched here so that it holds under any uid."""
    root = tmp_path / "checkout"
    root.mkdir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(name, root) == root / "build" / name
    (root / "build").mkdir()
    assert _build.build_dir(name, root) == root / "build" / name
    real = os.access
    monkeypatch.setattr(os, "access", lambda p, mode: (
        False if pathlib.Path(p).is_relative_to(root) else real(p, mode)))
    assert _build.build_dir(name, root) == \
        tmp_path / "home" / ".cache" / name
    # the checkout the tests run from is writable: both build there
    assert _build.BUILD_DIR == _build.ROOT / "build" / "vpc_torch_kernels"
    assert native_io.BUILD_DIR == _build.ROOT / "build" / "vpc_torch_io"
