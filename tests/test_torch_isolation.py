"""The port stands alone: it imports neither JAX nor anything of the JAX
package, its CLI scripts, tools, examples or native code. Checked twice: every module
is imported in a fresh interpreter whose import system refuses those names,
and every import statement of the port and of chip_smoke.py (including the
ones inside functions) is read from the source."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "vae_posterior_consistency_tpu_torch"
BLOCKED = ("jax", "jaxlib", "vae_posterior_consistency_tpu", "experiment_main",
           "tools", "examples", "native")


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_every_port_module_imports_with_the_jax_side_refused():
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys

        BLOCKED = {BLOCKED!r}

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                    raise ImportError(f"refused import of {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(REPO)!r})
        import vae_posterior_consistency_tpu_torch as pkg

        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for mod in ("parallel.mesh", "parallel.multihost",
                    "parallel.train_parallel", "engine.evaluate_sharded",
                    "tools.convert_reference_checkpoint",
                    "tools.convert_mnist_idx", "examples.impute_csv"):
            assert pkg.__name__ + "." + mod in names, mod
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if any(m == b or m.startswith(b + ".")
                               for b in BLOCKED))
        assert not leaked, leaked
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15  # every module was walked


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_reaches_the_jax_side(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert not [n for n in names if _blocked(n)], names


def test_the_data_plane_builds_from_the_port_s_own_source():
    """`data/native_io` compiles the port's copy of the C++ library,
    `csrc/vpc_io.cpp`, into the port's build directory, and names no file
    of the JAX package's `native/`."""
    from vae_posterior_consistency_tpu_torch.data import native_io

    assert native_io.SOURCE == PORT / "csrc" / "vpc_io.cpp"
    assert native_io.SOURCE.is_file()
    assert native_io.BUILD_DIR == REPO / "build" / "vpc_torch_io"
    text = (PORT / "data" / "native_io.py").read_text()
    assert "native/" not in text and "libvpc_io.so" not in text
    lib = native_io.library()
    assert pathlib.Path(lib._name).parent == native_io.BUILD_DIR
