"""The port's HDF5 reader and writer (shmgan_tpu_torch/runtime/hdf5.py)
against h5py, on the CPU.

The reader reads files h5py writes at libver "earliest" (superblock 0,
version-1 object headers, symbol-table groups, layout message 3, chunks in a
v1 B-tree) and "latest" (superblock 3, OHDR headers, link messages, layout
message 4, fixed-array and single-chunk indexes): every dtype the Keras
files and the dumps use, in both byte orders; contiguous, compact, chunked
(gzip, gzip with shuffle, fletcher32, one chunk, edge chunks, a multi-level
B-tree, the implicit index), empty, unwritten and scalar datasets; fixed and
variable-length string attributes, an empty attribute, numbers; and an
object header that needs a continuation block. Each value equals h5py's,
dtype and bytes. What it does not read raises a ValueError naming it.

The writer's files read in h5py to the same arrays and dtypes, chunked as
h5py chunks them and deflated at level 9; appending keeps every dataset, and
refuses an existing name, a root that holds a group, and root attributes.
"""

import os

import h5py
import numpy as np
import pytest
from h5py._hl.filters import guess_chunk as h5py_guess_chunk

from shmgan_tpu_torch.runtime import hdf5
from shmgan_tpu_torch.utils.viz import save_dataset_hdf5

LIBVERS = ("earliest", "latest")
DTYPES = ["<f2", ">f2", "<f4", ">f4", "<f8", ">f8", "|i1", "|u1", "<i2", ">u2", "<i4", ">i4",
          "<u4", "<i8", ">i8", "<u8"]


def _same(got, want, where=""):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (where, type(got))
        assert got.shape == want.shape and got.dtype == want.dtype, (where, got.dtype, want.dtype)
        if want.dtype == object:
            assert got.tolist() == want.tolist(), where
        else:
            assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _check_file(path):
    """Every object, attribute and value of `path` as h5py reads it; the
    number of values compared."""
    mine = hdf5.File(path)
    n = 0
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            nonlocal n
            got = mine[name]
            assert sorted(got.attrs) == sorted(obj.attrs), name
            for k, v in obj.attrs.items():
                _same(got.attrs[k], v, f"{name}@{k}")
                n += 1
            if isinstance(obj, h5py.Dataset):
                assert got.shape == obj.shape and got.dtype == obj.dtype, name
                _same(got[()], obj[()], name)
                n += 1
            else:
                assert got.keys() == list(obj.keys()), name
        for k, v in f.attrs.items():
            _same(mine.attrs[k], v, f"/@{k}")
            n += 1
        f.visititems(visit)
        assert mine.keys() == list(f.keys())
    return n


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_reader_dtypes(tmp_path, libver, dtype):
    rng = np.random.default_rng(DTYPES.index(dtype))
    a = (rng.standard_normal((5, 7)) * 100).astype(dtype)
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=a)
        f["x"].attrs["same"] = a[0]
        f.attrs["scalar"] = a[1, 2]
    assert _check_file(path) == 3
    assert hdf5.File(path)["x"].dtype == np.dtype(dtype)


def _dcpl(layout=None, chunk=None, early=False):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    if layout is not None:
        dcpl.set_layout(layout)
    if chunk is not None:
        dcpl.set_chunk(chunk)
    if early:
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _layouts(rng):
    f4 = rng.standard_normal((33, 17)).astype(np.float32)
    return {
        "contiguous": dict(data=f4),
        "compact": dict(data=np.arange(24, dtype="<i2").reshape(4, 6),
                        dcpl=_dcpl(h5py.h5d.COMPACT)),
        "chunked": dict(data=f4, chunks=(8, 5)),
        "gzip": dict(data=f4, chunks=(8, 5), compression="gzip", compression_opts=9),
        "gzip_shuffle": dict(data=rng.integers(-999, 999, (40, 9)).astype(">i4"), chunks=(7, 4),
                             compression="gzip", shuffle=True),
        "fletcher32": dict(data=rng.standard_normal(50).astype("<f8"), chunks=(16,),
                           fletcher32=True),
        "one_chunk": dict(data=f4, chunks=f4.shape, compression="gzip"),
        "many_chunks": dict(data=rng.standard_normal((40, 50, 3)).astype(np.float32),
                            chunks=(2, 3, 3), compression="gzip", shuffle=True),
        "implicit": dict(data=f4, dcpl=_dcpl(chunk=(8, 5), early=True)),
        "empty": dict(shape=(0,), dtype="f4"),
        "unwritten": dict(shape=(4, 3), dtype="f4"),
        "fillvalue": dict(shape=(5,), dtype="<i4", fillvalue=7),
        "scalar": dict(data=np.float64(3.5)),
        "images": dict(data=rng.random((8, 64, 64, 3), np.float32), compression="gzip",
                       compression_opts=9),
    }


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("layout", list(_layouts(np.random.default_rng(0))))
def test_reader_layouts(tmp_path, libver, layout):
    kw = _layouts(np.random.default_rng(1))[layout]
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", **kw)
    assert _check_file(path) == 1


def _attributes():
    return {
        "fixed_strings": np.array([b"conv2d", b"batch_normalization_1", b""]),
        "fixed_scalar": np.bytes_(b"2.8.0"),
        "vlen_scalar": '{"class_name": "Functional", "name": "é"}',
        "vlen_array": ["kernel:0", "", "bias:0"],
        "empty": np.asarray([]),
        "number": np.float32(1.25),
        "numbers": np.arange(12, dtype=">i8").reshape(3, 4),
    }


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("name", list(_attributes()))
def test_reader_attributes(tmp_path, libver, name):
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("layer")
        g.attrs[name] = _attributes()[name]
        g.create_dataset("w", data=np.ones(3, np.float32)).attrs[name] = _attributes()[name]
    assert _check_file(path) == 3


@pytest.mark.parametrize("libver", LIBVERS)
def test_reader_follows_header_continuations(tmp_path, libver):
    """Attributes added after a member: the object header grows a
    continuation block (h5py reports its chunks)."""
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        g = f.create_group("conv2d")
        g.create_dataset("conv2d/kernel:0", data=np.arange(27, dtype=np.float32))
        for i in range(7):
            g.attrs[f"a{i}"] = np.arange(40 + i, dtype=np.float64)
        assert h5py.h5o.get_info(g.id).hdr.nchunks > 1
    assert _check_file(path) == 8


def _refusal_cases():
    def dense_links(f):
        for i in range(12):
            f.create_group(f"g{i:02d}")

    def dense_attrs(f):
        for i in range(12):
            f.attrs[f"a{i:02d}"] = i

    return {
        "dense link storage": ("latest", dense_links, "/"),
        "dense attribute storage": ("latest", dense_attrs, "attrs"),
        "compound": ("earliest", lambda f: f.create_dataset(
            "x", data=np.zeros(3, [("a", "f4"), ("b", "i2")])), "x"),
        "enum": ("earliest", lambda f: f.create_dataset("x", data=np.ones(3, bool)), "x"),
        "soft link": ("latest", lambda f: f.__setitem__("x", h5py.SoftLink("/y")), "x"),
        "lzf filter": ("earliest", lambda f: f.create_dataset(
            "x", data=np.ones(64, np.float32), compression="lzf"), "x"),
        "variable-length sequence": ("earliest", lambda f: f.create_dataset(
            "x", shape=(2,), dtype=h5py.vlen_dtype(np.int32)), "x"),
        "reference": ("earliest", lambda f: f.create_dataset(
            "x", shape=(2,), dtype=h5py.ref_dtype), "x"),
    }


@pytest.mark.parametrize("feature", list(_refusal_cases()))
def test_reader_refuses_by_name(tmp_path, feature):
    libver, make, what = _refusal_cases()[feature]
    path = str(tmp_path / "t.h5")
    with h5py.File(path, "w", libver=libver) as f:
        make(f)
    with pytest.raises(ValueError, match=feature.split()[0]):
        f = hdf5.File(path)
        if what == "x":
            f["x"][()]


def test_reader_refuses_other_files(tmp_path):
    path = str(tmp_path / "t.h5")
    with open(path, "wb") as f:
        f.write(b"\0" * 4096)
    with pytest.raises(ValueError, match="not an HDF5 file"):
        hdf5.File(path)


WRITER_ARRAYS = {
    "images_f32": ((8, 64, 64, 3), "<f4"),
    "big_endian_f32": ((5, 6), ">f4"),
    "f16": ((100,), "<f2"),
    "f64": ((3, 4, 5), "<f8"),
    "i8": ((7, 9, 2), "|i1"),
    "u8": ((7, 9, 2), "|u1"),
    "i16": ((50,), "<i2"),
    "i64": ((2, 3), ">i8"),
    "empty": ((0,), "<f4"),
    "many_chunks": ((8, 256, 256, 3), "<f4"),
}


@pytest.mark.parametrize("case", list(WRITER_ARRAYS))
def test_writer_reads_in_h5py(tmp_path, case):
    shape, dtype = WRITER_ARRAYS[case]
    a = (np.random.default_rng(len(case)).standard_normal(shape) * 50).astype(dtype)
    path = str(tmp_path / "w.h5")
    size = hdf5.write_datasets(path, {"default": a})
    assert size == os.path.getsize(path)
    with h5py.File(path, "r") as f:
        d = f["default"]
        assert d.dtype == a.dtype and d.shape == a.shape
        assert d[()].tobytes() == a.tobytes()
        assert d.compression == "gzip" and d.compression_opts == 9
        assert d.chunks == h5py_guess_chunk(shape, None, a.dtype.itemsize)
    _same(hdf5.File(path)["default"][()], a)


def test_save_dataset_hdf5_appends(tmp_path):
    """viz.save_dataset_hdf5 as the JAX package's (h5py's "a" mode): each
    call adds a dataset and keeps the others, past one symbol-table node;
    h5py reads them all, and can itself append to the file."""
    path = str(tmp_path / "dump.hdf5")
    rng = np.random.default_rng(3)
    arrays = {f"d{i:02d}": rng.standard_normal((i + 1, 4)).astype(np.float32)
              for i in range(11)}
    arrays["default"] = rng.random((2, 16, 16, 3), np.float32)
    for name, a in arrays.items():
        size = save_dataset_hdf5(a, path, name)
        assert size == os.path.getsize(path)
    with h5py.File(path, "a") as f:
        assert sorted(f) == sorted(arrays)
        for name, a in arrays.items():
            assert f[name][()].tobytes() == a.tobytes(), name
        f.create_dataset("by_h5py", data=np.arange(3))
    mine = hdf5.File(path)
    assert mine["by_h5py"][()].tolist() == [0, 1, 2]
    assert mine["d07"][()].tobytes() == arrays["d07"].tobytes()


def _writer_refusals():
    def group(f):
        f.create_group("g")

    def root_attr(f):
        f.attrs["note"] = 1

    def dataset_attr(f):
        f.create_dataset("x", data=np.ones(2)).attrs["note"] = 1

    return {"existing name": (None, "already exists"), "group": (group, "group 'g'"),
            "root attribute": (root_attr, "attributes"),
            "dataset attribute": (dataset_attr, "attributes")}


@pytest.mark.parametrize("case", list(_writer_refusals()))
def test_writer_refusals(tmp_path, case):
    make, message = _writer_refusals()[case]
    path = str(tmp_path / "w.h5")
    if make is None:
        save_dataset_hdf5(np.ones(3, np.float32), path)
    else:
        with h5py.File(path, "w") as f:
            make(f)
    before = open(path, "rb").read()
    with pytest.raises(ValueError, match=message):
        save_dataset_hdf5(np.zeros(3, np.float32), path)
    assert open(path, "rb").read() == before


def test_writer_refuses_scalars_and_other_dtypes(tmp_path):
    with pytest.raises(ValueError, match="scalar"):
        hdf5.write_datasets(str(tmp_path / "a.h5"), {"x": np.float32(1)})
    with pytest.raises(ValueError, match="complex"):
        hdf5.write_datasets(str(tmp_path / "b.h5"), {"x": np.ones(2, np.complex64)})
