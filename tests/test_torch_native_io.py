"""The port's native data plane (`data/native_io`, its own copy of the C++
library in `csrc/vpc_io.cpp`) against the JAX package's `data/native_io`:
the ABI version, the CSV reader on every index CSV of `Data/`, the mask
codec, the MCAR mask bits through the library and through the numpy
fallback, the refusals, the fallback after a failed build, and the loaders
reading their index CSVs through it."""

import glob
import os

import numpy as np
import pytest

from vae_posterior_consistency_tpu.data import native_io as jnio
from vae_posterior_consistency_tpu_torch.data import loaders as tloaders
from vae_posterior_consistency_tpu_torch.data import native_io as tnio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDEX_CSVS = sorted(glob.glob(os.path.join(REPO, "Data", "*",
                                           "*_index*.csv")))


@pytest.fixture
def fallback(monkeypatch):
    """Both packages on their numpy fallbacks, as on a host without g++."""
    monkeypatch.setattr(tnio, "_load", lambda: None)
    monkeypatch.setattr(jnio, "_load", lambda: None)


def test_the_library_builds_from_the_port_s_source_at_jax_s_abi():
    assert tnio.available() and jnio.available()
    lib = tnio.library()
    assert tnio.ABI_VERSION == jnio._ABI_VERSION == 3
    assert lib.vpc_io_abi_version() == 3
    assert str(tnio.SOURCE) == os.path.join(
        REPO, "vae_posterior_consistency_tpu_torch", "csrc", "vpc_io.cpp")
    assert lib._name.startswith(os.path.join(REPO, "build", "vpc_torch_io",
                                             "libvpc_io_"))


def test_read_csv_equals_jax_s_and_loadtxt_on_every_index_csv():
    assert len(INDEX_CSVS) >= 6
    before = tnio.read_csv.native_calls
    for path in INDEX_CSVS:
        got = tnio.read_csv(path)
        np.testing.assert_array_equal(got, jnio.read_csv(path))
        want = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tnio.read_csv.native_calls == before + len(INDEX_CSVS)


def test_read_csv_of_a_float_table_in_both_paths(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(37, 5)).astype(np.float32)
    path = str(tmp_path / "t.csv")
    np.savetxt(path, table, delimiter=",", fmt="%.9g")
    native = tnio.read_csv(path)
    np.testing.assert_array_equal(native, jnio.read_csv(path))
    np.testing.assert_array_equal(native, table)
    monkeypatch.setattr(tnio, "_load", lambda: None)
    np.testing.assert_array_equal(tnio.read_csv(path), native)


@pytest.mark.parametrize("text,error", [
    ("1,2\n3,4,5\n", "ragged"),  # a final row wider than the first
    ("1,2,3\n4,5\n", "ragged"),
    ("1,2\n3.1.4,4\n", None), ("1,2\n12abc,4\n", None)])
def test_read_csv_refuses_what_jax_s_refuses(tmp_path, text, error):
    path = str(tmp_path / "bad.csv")
    with open(path, "w") as fh:
        fh.write(text)
    for module in (tnio, jnio):
        with pytest.raises(ValueError, match=error):
            module.read_csv(path)


def test_a_missing_file_raises_file_not_found_in_both_paths(monkeypatch):
    with pytest.raises(FileNotFoundError):
        tnio.read_csv("/nonexistent/file.csv")
    monkeypatch.setattr(tnio, "_load", lambda: None)
    with pytest.raises(FileNotFoundError):
        tnio.read_csv("/nonexistent/file.csv")


@pytest.mark.parametrize("shape", [(64, 12), (7, 3), (1, 1), (100, 13)])
def test_mask_codec_equals_jax_s_and_packbits(shape):
    mask = (np.random.default_rng(1).random(shape) < 0.5).astype(np.float32)
    packed = tnio.pack_mask(mask)
    np.testing.assert_array_equal(packed, jnio.pack_mask(mask))
    np.testing.assert_array_equal(
        packed, np.packbits(mask.astype(bool).ravel(), bitorder="little"))
    back = tnio.unpack_mask(packed, shape)
    np.testing.assert_array_equal(back, mask)
    np.testing.assert_array_equal(back, jnio.unpack_mask(packed, shape))
    with pytest.raises(ValueError, match="fewer than"):
        tnio.unpack_mask(packed[:0], shape)


def test_mask_codec_fallback_gives_the_same_bytes(fallback):
    mask = (np.random.default_rng(2).random((33, 5)) < 0.4).astype(
        np.float32)
    packed = tnio.pack_mask(mask)
    np.testing.assert_array_equal(packed, jnio.pack_mask(mask))
    np.testing.assert_array_equal(tnio.unpack_mask(packed, (33, 5)), mask)


@pytest.mark.parametrize("seed,rate", [(42, 30.0), (7, 50.0),
                                       (2 ** 64 - 1, 30.0), (-3, 10.0)])
def test_mcar_mask_bits_equal_jax_s_native_and_fallback(monkeypatch, seed,
                                                        rate):
    """xorshift128+ in the library and in the Python fallback: the same
    bits in both packages, with or without g++ (a negative seed wraps to
    64 bits, as JAX's)."""
    shape = (300, 7)
    before = tnio.mcar_mask.native_calls
    native = tnio.mcar_mask(shape, rate, seed)
    assert tnio.mcar_mask.native_calls == before + 1
    np.testing.assert_array_equal(native, jnio.mcar_mask(shape, rate, seed))
    assert native.dtype == np.float32 and native.shape == shape
    assert abs(native.mean() - (1 - rate / 100)) < 0.05
    monkeypatch.setattr(tnio, "_load", lambda: None)
    monkeypatch.setattr(jnio, "_load", lambda: None)
    fallback = tnio.mcar_mask(shape, rate, seed)
    np.testing.assert_array_equal(fallback, native)
    np.testing.assert_array_equal(fallback, jnio.mcar_mask(shape, rate, seed))
    np.testing.assert_array_equal(
        tnio._xorshift128p_uniforms(50, 9), jnio._xorshift128p_uniforms(50, 9))


def test_a_failed_build_falls_back_and_library_says_why(tmp_path,
                                                        monkeypatch):
    """A source g++ refuses: `library()` raises with g++'s message and
    leaves nothing in the build directory; `available()` is False and every
    function takes its numpy fallback."""
    bad = tmp_path / "vpc_io.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnio, "SOURCE", bad)
    monkeypatch.setattr(tnio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnio, "_lib", None)
    monkeypatch.setattr(tnio, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on vpc_io.cpp"):
        tnio.library()
    assert not tnio.available()
    assert os.listdir(tmp_path / "build") == []
    path = INDEX_CSVS[0]
    before = tnio.read_csv.native_calls
    np.testing.assert_array_equal(tnio.read_csv(path), jnio.read_csv(path))
    assert tnio.read_csv.native_calls == before


def test_the_loaders_read_their_index_csvs_through_the_library():
    before = tnio.read_csv.native_calls
    ds = tloaders.data_loader(os.path.join(REPO, "Data"), "reg_vae2", 30, 64,
                              "wine", device="cpu")
    assert tnio.read_csv.native_calls == before + 2
    want = jnio.read_csv(os.path.join(REPO, "Data", "wine",
                                      "test_index2.csv"))
    assert ds.test.n == want.size
    np.testing.assert_array_equal(
        tloaders._load_indices(os.path.join(REPO, "Data", "wine",
                                            "test_index2.csv")),
        want.astype(np.int64).ravel())
