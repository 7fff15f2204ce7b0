"""The pure-NumPy HDF5 subset used where h5py is not installed: its files
must read back in h5py (they are real HDF5), round-trip through itself, and
carry a whole sim folder through cli sim and cli process."""

import h5py
import numpy as np
import pytest

from pffdtd_jax.io import h5 as h5io
from pffdtd_jax.io import hdf5_lite as lite

CASES = {
    "i64_1d": np.arange(10, dtype=np.int64),
    "f64_2d": np.linspace(-1.0, 1.0, 12).reshape(3, 4),
    "f64_scalar": np.float64(2.5),
    "i8_scalar": np.int8(-3),
    "i64_empty": np.zeros((0,), np.int64),
    "bool_2d": np.array([[True, False], [False, True]]),
    "f32_1d": np.float32([1.5, -2.0]),
    "u16_1d": np.uint16([65535, 1]),
    "f64_3d": np.arange(24, dtype=np.float64).reshape(2, 3, 4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_lite_file_reads_in_h5py_and_back(name, tmp_path):
    data = CASES[name]
    want = np.asarray(data)
    want = want.astype(np.uint8) if want.dtype == bool else want
    p = tmp_path / "t.h5"
    lite.write(p, {name: data, "other": np.ones(3)})
    with h5py.File(p, "r") as f:
        got = f[name][()]
        assert sorted(f.keys()) == sorted([name, "other"])
    assert np.asarray(got).dtype == want.dtype
    assert np.shape(got) == want.shape and np.array_equal(got, want)
    back = lite.read(p)[name]
    assert back.dtype == want.dtype and np.array_equal(back, want)


def test_lookup3_reference_vectors():
    # from the self-test of Bob Jenkins' lookup3.c
    assert lite.lookup3(b"") == 0xDEADBEEF
    s = b"Four score and seven years ago"
    assert lite.lookup3(s) == 0x17770551
    assert lite.lookup3(s, 1) == 0xCD628161


def test_update_in_place(tmp_path):
    p = tmp_path / "t.h5"
    lite.write(p, {"a": np.arange(4), "c": np.float64(1.0), "b": np.ones(2)})
    with lite.File(p, "r+") as f:
        f["c"][()] = 7.0
        f["a"][...] = np.arange(4)[::-1]
        del f["b"]
        f.create_dataset("r_out", data=np.zeros(3), compression="gzip")
    with h5py.File(p, "r") as f:
        assert f["c"][()] == 7.0 and "b" not in f
        assert np.array_equal(f["a"][...], [3, 2, 1, 0])
        assert np.array_equal(f["r_out"][...], np.zeros(3))
    with lite.File(p, "r") as f, pytest.raises(OSError):
        f["c"][()] = 1.0


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_refuses_libhdf5_files(libver, tmp_path):
    p = tmp_path / "h.h5"
    with h5py.File(p, "w", libver=libver) as f:
        f.create_dataset("x", data=np.ones(3))
    with pytest.raises(lite.FormatError, match="h5py"):
        lite.read(p)


def test_sim_folder_without_h5py(tmp_path, monkeypatch):
    """The whole folder path (setup -> cli sim -> cli process) on the
    pure-NumPy files, as on a machine without h5py."""
    from pffdtd_jax.cli import main
    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.engine.numpy_ref import NumpyEngine
    from pffdtd_jax.scene_setup import save_sim_data

    monkeypatch.setattr(h5io, "H5File", lite.File)
    sim = synthetic_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=48, lossy=True,
                            insig_type="hann10", diff_source=False)
    save_sim_data(sim, tmp_path)
    main(["sim", "--data_dir", str(tmp_path), "--f64"])
    main(["process", "--data_dir", str(tmp_path), "--fcut_lowpass", "800"])
    for f in ("sim_consts", "vox_out", "comms_out", "sim_mats", "sim_outs",
              "sim_outs_processed"):
        lite.read(tmp_path / f"{f}.h5")    # written by the subset
    ref = NumpyEngine(tmp_path)
    ref.run_all()
    with h5py.File(tmp_path / "sim_outs.h5", "r") as f:
        u = f["u_out"][...]
        assert "r_out" in f
    want = ref.u_out[ref.comms.out_reorder]
    assert np.abs(u - want).max() < 1e-12 * np.abs(want).max()
