"""The port's MNIST IDX converter (`tools/convert_mnist_idx`) against the
JAX package's `tools/convert_mnist_idx.py`: the same synthetic IDX files
give the same tensors, byte for byte, which the port's MNIST loader reads;
both refuse a wrong magic number and a truncated file."""

import gzip
import struct

import numpy as np
import pytest
import torch

from tools import convert_mnist_idx as jidx
from vae_posterior_consistency_tpu.data import loaders as jloaders
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.tools import convert_mnist_idx as tidx

NAMES = [f"experiment_{s}_{k}.pt" for s in ("train", "test")
         for k in ("data", "mask")]


def _write_idx(path, n, seed, magic=2051, cut=0):
    pixels = np.random.default_rng(seed).integers(0, 256, (n, 28, 28),
                                                  dtype=np.uint8)
    blob = struct.pack(">IIII", magic, n, 28, 28) + pixels.tobytes()
    blob = blob[:len(blob) - cut]
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(blob)
    return pixels


@pytest.mark.parametrize("suffix", ["", ".gz"])
def test_the_files_are_jax_s_and_the_loader_reads_them(tmp_path, suffix,
                                                       capsys):
    train = tmp_path / f"train-images-idx3-ubyte{suffix}"
    test = tmp_path / f"t10k-images-idx3-ubyte{suffix}"
    pixels = _write_idx(train, 12, 0)
    _write_idx(test, 5, 1)
    jidx.convert(str(train), str(test), str(tmp_path / "jax" / "mnist"),
                 missing_rate=30, seed=7)
    tidx.main(["--train_images", str(train), "--test_images", str(test),
               "--out", str(tmp_path / "port" / "mnist"),
               "--missing_rate", "30", "--seed", "7"])
    out = capsys.readouterr().out
    assert "train: 12 images x 784 px" in out
    for name in NAMES:
        want = torch.load(tmp_path / "jax" / "mnist" / name)
        got = torch.load(tmp_path / "port" / "mnist" / name)
        assert got.dtype == want.dtype and torch.equal(got, want), name
    np.testing.assert_array_equal(
        tidx.read_idx_images(str(train)),
        pixels.reshape(12, 784).astype(np.float32) / 255.0)

    ds = tloaders.data_loader_mnist(str(tmp_path / "port"), "reg_EDDI1", 30,
                                    64, device="cpu")
    jds = jloaders.data_loader_mnist(str(tmp_path / "jax"), "reg_EDDI1", 30,
                                     64)
    for got, want in ((ds.train, jds.train), (ds.test, jds.test)):
        assert got.x.dtype == got.mask.dtype == torch.float32
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert ds.train.n == 12 and ds.test.n == 5 and ds.obs_dim == 784
    assert 0.6 < float(ds.train.mask.mean()) < 0.8


@pytest.mark.parametrize("kind,match", [("magic", "not an IDX3"),
                                        ("truncated", "truncated")])
def test_a_bad_file_is_refused_as_in_jax(tmp_path, kind, match):
    path = tmp_path / "bad-idx3-ubyte"
    _write_idx(path, 3, 0, magic=2049 if kind == "magic" else 2051,
               cut=10 if kind == "truncated" else 0)
    for read in (jidx.read_idx_images, tidx.read_idx_images):
        with pytest.raises(ValueError, match=match):
            read(str(path))
