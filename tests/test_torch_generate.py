"""The port's `data/generate` against the JAX package's: from the same seed
both write the same files, tensor for tensor (dtype and shape included)
and the index CSVs byte for byte, for every UCI table, the MNIST stand-in
and the command line; a partial MNIST set is refused by both."""

import os

import numpy as np
import pytest
import torch

from vae_posterior_consistency_tpu.data import generate as jgen
from vae_posterior_consistency_tpu_torch.data import generate as tgen


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_tree(got_root, want_root):
    names = _files(want_root)
    assert names and _files(got_root) == names
    for name in names:
        got, want = (os.path.join(r, name) for r in (got_root, want_root))
        if name.endswith(".csv"):
            with open(got, "rb") as g, open(want, "rb") as w:
                assert g.read() == w.read(), name
            continue
        a = torch.load(got, weights_only=True)
        b = torch.load(want, weights_only=True)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("data_type", ["wine", "digits", "cancer",
                                       "synth_small", "synth"])
def test_generate_uci_writes_jax_s_files(tmp_path, data_type):
    for module, root in ((tgen, "port"), (jgen, "jax")):
        module.generate_uci(str(tmp_path / root), data_type, seed=11)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    mcar = torch.load(tmp_path / "port" / data_type / "mask_30_missing1.pt",
                      weights_only=True)
    mnar = torch.load(tmp_path / "port" / data_type /
                      "mnar_mask_missing1.pt", weights_only=True)
    assert mcar.dtype == torch.bool and mnar.dtype == torch.float32


def test_generate_mnist_writes_jax_s_files_and_keeps_a_whole_set(tmp_path):
    for module, root in ((tgen, "port"), (jgen, "jax")):
        module.generate_mnist(str(tmp_path / root), seed=3)
    _same_tree(tmp_path / "port", tmp_path / "jax")
    data = torch.load(tmp_path / "port" / "mnist" /
                      "experiment_train_data.pt", weights_only=True)
    assert data.shape[1] == 784
    # a whole set (e.g. genuine MNIST) is left as it is
    path = tmp_path / "port" / "mnist" / "experiment_test_mask.pt"
    stamp = os.path.getmtime(path)
    tgen.generate_mnist(str(tmp_path / "port"), seed=4)
    assert os.path.getmtime(path) == stamp


def test_a_partial_mnist_set_is_refused_by_both(tmp_path):
    for module, root in ((tgen, "port"), (jgen, "jax")):
        out = tmp_path / root / "mnist"
        out.mkdir(parents=True)
        torch.save(torch.zeros(2, 784), out / "experiment_train_data.pt")
        with pytest.raises(FileExistsError, match="partial MNIST"):
            module.generate_mnist(str(tmp_path / root))


def test_main_tiny_writes_jax_s_files(tmp_path):
    for module, root in ((tgen, "port"), (jgen, "jax")):
        module.main(["--tiny", "--root", str(tmp_path / root),
                     "--seed", "5"])
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert _files(tmp_path / "port")[0].startswith("synth_small")
    index = np.loadtxt(tmp_path / "port" / "synth_small" / "test_index1.csv",
                       delimiter=",", ndmin=1)
    assert index.size == 12  # 10% of the 120 rows
