"""The data plane of the PyTorch port vs the JAX package: every contract case
of tests/test_data_plane.py on the port's memory, file and device (CPU)
factories; file arrays written by either package read back byte-equal in
the other; the port's BucketReader gives the JAX package's PartRefs and
bytes in both orders; the device backend's packed commit and its device
views.  Inputs are made from a seed with numpy."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gpu_radix_sort_tpu.data import FileArrayFactory as JaxFileArrayFactory
from gpu_radix_sort_tpu.data import MemArrayFactory as JaxMemArrayFactory
from gpu_radix_sort_tpu.parallel.bucket_reader import BucketReader as JaxBucketReader
from gpu_radix_sort_tpu.parallel.bucket_reader import ReadOrder as JaxReadOrder
from gpu_radix_sort_tpu_torch.data import (
    CapacityError,
    DeviceArrayFactory,
    DistribArrayShape,
    FileArrayFactory,
    MemArrayFactory,
    PartRef,
    create_shape,
    create_shape_uniform,
    fetch_part_refs,
    fetch_part_refs_u32,
)
from gpu_radix_sort_tpu_torch.parallel import BucketReader, ReadOrder

CPU = torch.device("cpu")


@pytest.fixture(params=["mem", "file", "device"])
def factory(request, tmp_path):
    if request.param == "mem":
        return MemArrayFactory()
    if request.param == "file":
        return FileArrayFactory(str(tmp_path / "arrays"))
    return DeviceArrayFactory("cpu")


def _random_parts(rng, caps):
    return [rng.integers(0, 256, size=c, dtype=np.uint8).tobytes() for c in caps]


def test_create_shape_validation():
    s = create_shape_uniform(16, 4)
    assert s.npart == 4 and s.caps == (16,) * 4 and s.lens == (0,) * 4
    assert s.starts() == (0, 16, 32, 48)
    with pytest.raises(ValueError):
        create_shape([-1])


@pytest.mark.parametrize("npart", [1000, 1025, 1 << 16])
def test_shape_check_and_starts_above_1024_parts(npart):
    """The vectorised check above 1024 parts agrees with the loop below."""
    rng = np.random.default_rng(npart)
    caps = rng.integers(0, 50, npart)
    lens = rng.integers(0, 1 + caps)
    s = DistribArrayShape(lens.tolist(), caps.tolist())
    assert s.lens == tuple(lens.tolist()) and s.caps == tuple(caps.tolist())
    assert s.starts() == tuple((np.cumsum(caps) - caps).tolist())
    assert s.total_len() == int(lens.sum()) and s.total_cap() == int(caps.sum())
    bad = lens.copy()
    bad[npart // 2] = caps[npart // 2] + 1
    with pytest.raises(ValueError, match=f"partition {npart // 2}"):
        DistribArrayShape(bad.tolist(), caps.tolist())


def test_read_write(factory, rng):
    caps = [64, 0, 128]
    arr = factory.create("rw", create_shape(caps))
    parts = _random_parts(rng, caps)
    arr.write_all(parts)
    arr.close()
    shape = arr.get_shape()
    assert shape.lens == tuple(len(p) for p in parts)
    for i, p in enumerate(parts):
        assert arr.read_part(i) == p
    assert arr.read_all() == b"".join(parts)


def test_reread_is_independent(factory, rng):
    arr = factory.create("reread", create_shape_uniform(64, 1))
    data = _random_parts(rng, [64])[0]
    arr.write_part(0, data)
    arr.close()
    r1 = arr.get_part_reader(0)
    r2 = arr.get_part_reader(0)
    assert r1.read(10) == data[:10]
    assert r2.read() == data
    assert r1.read() == data[10:]
    r1.close(), r2.close()


def test_reader_eof_contract(factory):
    arr = factory.create("eof", create_shape_uniform(8, 1))
    arr.write_part(0, b"abc")
    arr.close()
    r = arr.get_part_reader(0)
    assert r.read(2) == b"ab"
    assert r.read(100) == b"c"
    assert r.read(1) == b""
    assert r.read() == b""
    r.close()


def test_partial_append_then_more(factory):
    arr = factory.create("append", create_shape_uniform(10, 1))
    w = arr.get_part_writer(0)
    w.write(b"hello")
    w.close()
    arr.close()
    assert arr.read_part(0) == b"hello"
    arr.write_part(0, b"world")
    arr.close()
    assert arr.read_part(0) == b"helloworld"
    assert arr.get_shape().lens == (10,)


def test_capacity_overflow(factory):
    arr = factory.create("cap", create_shape_uniform(4, 1))
    with pytest.raises(CapacityError):
        arr.write_part(0, b"12345")
    arr.write_part(0, b"1234")
    arr.close()
    with pytest.raises(CapacityError):
        arr.write_part(0, b"x")


def test_range_reader_windows(factory):
    arr = factory.create("range", create_shape_uniform(16, 1))
    arr.write_part(0, b"0123456789")  # len 10, cap 16
    arr.close()
    with arr.get_part_range_reader(0, 2, 5) as r:
        assert r.read() == b"234"
    # end <= 0 is relative to the committed LENGTH on every backend
    with arr.get_part_range_reader(0, 0, 0) as r:
        assert r.read() == b"0123456789"
    with arr.get_part_range_reader(0, 3, -2) as r:
        assert r.read() == b"34567"
    with pytest.raises(ValueError):
        arr.get_part_range_reader(0, 0, 11)
    with pytest.raises(ValueError):
        arr.get_part_range_reader(0, 5, 3)


def test_reopen_by_name(factory, rng):
    caps = [32, 32]
    arr = factory.create("reopen", create_shape(caps))
    parts = _random_parts(rng, caps)
    arr.write_all(parts)
    arr.close()
    again = factory.open("reopen")
    assert again.get_shape().lens == (32, 32)
    assert again.read_all() == b"".join(parts)


def test_multiple_arrays(factory, rng):
    a = factory.create("multi_a", create_shape_uniform(16, 2))
    b = factory.create("multi_b", create_shape_uniform(16, 2))
    pa = _random_parts(rng, [16, 16])
    pb = _random_parts(rng, [16, 16])
    a.write_all(pa), b.write_all(pb)
    a.close(), b.close()
    assert factory.open("multi_a").read_all() == b"".join(pa)
    assert factory.open("multi_b").read_all() == b"".join(pb)


def test_destroy_frees_name(factory):
    arr = factory.create("gone", create_shape_uniform(4, 1))
    arr.write_part(0, b"data")
    arr.close()
    arr.destroy()
    with pytest.raises(FileNotFoundError):
        factory.open("gone")
    arr2 = factory.create("gone", create_shape_uniform(4, 1))
    arr2.write_part(0, b"new!")
    arr2.close()
    assert factory.open("gone").read_part(0) == b"new!"


def test_open_missing(factory):
    with pytest.raises(FileNotFoundError):
        factory.open("never_created")


def test_duplicate_create(factory):
    factory.create("dup", create_shape_uniform(4, 1))
    with pytest.raises(FileExistsError):
        factory.create("dup", create_shape_uniform(4, 1))


def test_fetch_part_refs(factory, rng):
    a = factory.create("fetch_a", create_shape_uniform(32, 2))
    b = factory.create("fetch_b", create_shape_uniform(32, 1))
    pa = _random_parts(rng, [32, 32])
    pb = _random_parts(rng, [32])
    a.write_all(pa), b.write_all(pb)
    a.close(), b.close()
    refs = [PartRef(a, 0, 4, 8), PartRef(b, 0, 0, 32), PartRef(a, 1, 28, 4)]
    got = fetch_part_refs(refs)
    assert bytes(got) == pa[0][4:12] + pb[0] + pa[1][28:32]
    assert PartRef(a, 1, 0, 0).reader().read() == b""  # an empty ref is empty


def test_fetch_part_refs_u32(factory):
    arr = factory.create("fetch_u32", create_shape_uniform(16, 1))
    keys = np.array([7, 1, 9, 3], dtype=np.uint32)
    arr.write_part(0, keys.tobytes())
    arr.close()
    got = fetch_part_refs_u32([PartRef(arr, 0, 0, 16)])
    np.testing.assert_array_equal(got, keys)
    assert got.flags.writeable  # torch.from_numpy takes it without a warning
    with pytest.raises(ValueError):
        fetch_part_refs_u32([PartRef(arr, 0, 0, 6)])


def test_file_format_is_reference_compatible(tmp_path):
    root = str(tmp_path / "wire")
    f = FileArrayFactory(root)
    arr = f.create("wire_arr", create_shape([8, 16]))
    arr.write_part(0, b"AAAA")
    arr.write_part(1, b"BBBBBBBB")
    arr.close()
    d = os.path.join(root, "wire_arr")
    with open(os.path.join(d, "meta.json")) as fh:
        assert json.load(fh) == {"Lens": [4, 8], "Caps": [8, 16]}
    with open(os.path.join(d, "data.dat"), "rb") as fh:
        raw = fh.read()
    assert len(raw) == 24  # preallocated to total cap
    assert raw[0:4] == b"AAAA" and raw[8:16] == b"BBBBBBBB"


def _array_files(root: str, name: str) -> tuple[bytes, bytes]:
    d = os.path.join(root, name)
    with open(os.path.join(d, "meta.json"), "rb") as m, open(os.path.join(d, "data.dat"), "rb") as f:
        return m.read(), f.read()


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("caps", [[8, 0, 16], [4] * 3000])
def test_file_arrays_cross_packages_byte_equal(tmp_path, writer, caps):
    """An array written by one package's file backend reads back
    byte-equal through the other's, and both write the same files."""
    rng = np.random.default_rng(len(caps))
    lens = [int(rng.integers(0, c + 1)) for c in caps]
    parts = [rng.integers(0, 256, ln, dtype=np.uint8).tobytes() for ln in lens]
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    factories = {"jax": JaxFileArrayFactory(roots["jax"]),
                 "port": FileArrayFactory(roots["port"])}
    for side, fac in factories.items():
        arr = fac.create("x", create_shape(caps))
        for i, p in enumerate(parts):
            if p:
                arr.write_part(i, p[: len(p) // 2])
                arr.write_part(i, p[len(p) // 2:])
        arr.close()
    assert _array_files(roots["jax"], "x") == _array_files(roots["port"], "x")
    reader = "port" if writer == "jax" else "jax"
    other = {"jax": JaxFileArrayFactory, "port": FileArrayFactory}[reader](roots[writer])
    arr = other.open("x")
    assert arr.get_shape().lens == tuple(lens)
    assert [arr.read_part(i) for i in range(len(caps))] == parts
    mid = next(i for i, ln in enumerate(lens) if ln >= 2)
    with arr.get_part_range_reader(mid, 1, -1) as r:
        assert r.read() == parts[mid][1:-1]


def _filled(fac, name, rng, lens, caps=None):
    arr = fac.create(name, create_shape(caps or lens))
    for i, ln in enumerate(lens):
        if ln:
            arr.write_part(i, rng.integers(0, 256, ln, dtype=np.uint8).tobytes())
    arr.close()
    return arr


def _ref_tuples(refs):
    return [(r.arr.name, r.part_idx, r.start, r.nbyte) for r in refs]


@pytest.mark.parametrize("order", ["STRIDED", "INORDER"])
@pytest.mark.parametrize("chunk", [1, 4, 37, 1000])
def test_bucket_reader_matches_jax(order, chunk):
    """The same PartRefs (name, part, start, nbyte) and bytes as the JAX
    package's BucketReader over the same arrays, ragged and with empty
    partitions, read in chunks of ``chunk`` bytes."""
    lens = [[12, 0, 40, 4, 0], [0, 0, 8], [28, 4, 0, 0, 16, 24]]
    sides = []
    for fac, reader, orders in ((MemArrayFactory(), BucketReader, ReadOrder),
                                (JaxMemArrayFactory(), JaxBucketReader, JaxReadOrder)):
        rng = np.random.default_rng(5)
        arrs = [_filled(fac, f"b{i}", rng, ln) for i, ln in enumerate(lens)]
        ref_reader = reader(arrs, orders[order])
        byte_reader = reader(arrs, orders[order])
        refs, chunks = [], []
        while True:
            got = ref_reader.read_ref(chunk)
            if not got:
                break
            refs.append(_ref_tuples(got))
            chunks.append(byte_reader.read(chunk))
        assert byte_reader.read(chunk) == b""
        sides.append((refs, chunks, ref_reader.total_bytes))
    assert sides[0] == sides[1]
    assert sides[0][2] == sum(map(sum, lens))


def test_device_factory_needs_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        assert DeviceArrayFactory().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeviceArrayFactory()
    assert DeviceArrayFactory("cpu").device == CPU


def test_device_put_device_part():
    f = DeviceArrayFactory("cpu")
    arr = f.create("dev_direct", create_shape_uniform(16, 1))
    dev = torch.arange(8, dtype=torch.uint8)
    arr.put_device_part(0, dev)
    arr.close()
    assert arr.read_part(0) == bytes(range(8))
    assert arr.device_slice(0) is dev
    with pytest.raises(IOError):
        arr.put_device_part(0, dev)
    other = f.create("dev_bad", create_shape_uniform(16, 2))
    with pytest.raises(ValueError):
        other.put_device_part(0, torch.arange(8, dtype=torch.int32))
    with pytest.raises(CapacityError):
        other.put_device_part(1, torch.zeros(17, dtype=torch.uint8))


def test_device_put_device_packed():
    f = DeviceArrayFactory("cpu")
    arr = f.create("dev_packed", create_shape([8, 0, 12]))
    backing = torch.arange(20, dtype=torch.uint8)
    arr.put_device_packed(backing, [8, 0, 12])
    arr.close()
    assert list(arr.get_shape().lens) == [8, 0, 12]
    assert arr.read_part(0) == bytes(range(8))
    assert arr.read_part(1) == b""
    assert arr.read_part(2) == bytes(range(8, 20))
    win = arr.device_range(2, 4, 6)
    assert win.numpy().tobytes() == bytes(range(12, 18))
    assert win.data_ptr() == backing.data_ptr() + 12  # a view, not a copy
    assert arr.device_range(1).numel() == 0
    with pytest.raises(IOError):
        arr.write_part(0, b"x")
    with pytest.raises(IOError):
        arr.put_device_packed(backing, [8, 0, 12])
    with pytest.raises(IOError):
        arr.put_device_part(1, backing[:0])
    arr2 = f.create("dev_packed2", create_shape([4]))
    with pytest.raises(CapacityError):
        arr2.put_device_packed(backing, [20])
    arr3 = f.create("dev_packed3", create_shape([64]))
    with pytest.raises(ValueError):
        arr3.put_device_packed(backing, [8])


def test_device_appends_match_jax_device_backend(rng):
    """Appends staged on the host and moved on close, read back as the JAX
    package's device backend reads them."""
    from gpu_radix_sort_tpu.data import DeviceArrayFactory as JaxDeviceArrayFactory

    caps = [64, 0, 96]
    parts = _random_parts(rng, [30, 0, 96])
    got = []
    for fac in (DeviceArrayFactory("cpu"), JaxDeviceArrayFactory(jax.devices("cpu")[0])):
        arr = fac.create("appends", create_shape(caps))
        arr.write_part(0, parts[0][:10])
        arr.close()
        arr.write_part(0, parts[0][10:])
        arr.write_part(2, parts[2])
        arr.close()
        got.append(([arr.read_part(i) for i in range(3)], arr.get_shape().lens,
                    bytes(np.asarray(arr.device_range(2, 8, 16)))))
    assert got[0] == got[1]
    assert got[0][0] == parts
