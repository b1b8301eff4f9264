"""The port's point-cloud IO (``utils/io.py``) and native parser
(``utils/native.py`` with ``native/loader.cpp``) against the JAX
package's: the cases of ``tests/test_io.py`` and ``tests/test_native.py``
on the port, and every format loaded bit-equal by both packages from the
same bytes, with the native library and with its NumPy twins.
"""

import time
from pathlib import Path

import numpy as np
import pytest

from lidar_ai_recommendation_software_tpu.utils import io as jax_io
from lidar_ai_recommendation_software_tpu.utils import native as jax_native
from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
from lidar_ai_recommendation_software_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def pts():
    rng = np.random.RandomState(0)
    return rng.uniform(-10, 10, (500, 3))


# -- the cases of tests/test_io.py ---------------------------------------------

@pytest.mark.parametrize("fmt", ["npy", "xyz", "txt", "csv", "pcd", "ply",
                                 "las"])
def test_roundtrip(tmp_path, pts, fmt):
    p = str(tmp_path / f"cloud.{fmt}")
    pio.save_points(p, pts)
    out = pio.load_points(p)
    assert out.shape == (500, 3)
    atol = 1e-5 if fmt in ("las",) else 1e-6
    np.testing.assert_allclose(out, pts, atol=atol)


def test_csv_with_named_columns(tmp_path, pts):
    import pandas as pd
    p = str(tmp_path / "named.csv")
    pd.DataFrame({"intensity": np.ones(len(pts)), "X": pts[:, 0],
                  "Y": pts[:, 1], "Z": pts[:, 2]}).to_csv(p, index=False)
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-8)


def test_text_skips_garbage_lines(tmp_path):
    p = str(tmp_path / "messy.xyz")
    with open(p, "w") as f:
        f.write("# comment\n1.0 2.0 3.0\nnot a line\n4,5,6\n7;8;9\n")
    out = pio.load_points(p)
    np.testing.assert_allclose(out, [[1, 2, 3], [4, 5, 6], [7, 8, 9]])


def test_bytes_source_requires_fmt(pts):
    raw = pts.astype("<f8").tobytes()
    with pytest.raises(pio.LoaderError):
        pio.load_points(raw)


def test_empty_cloud_raises(tmp_path):
    p = str(tmp_path / "empty.xyz")
    with open(p, "w") as f:
        f.write("# nothing\n")
    with pytest.raises(pio.LoaderError):
        pio.load_points(p)


def test_laz_rejected(tmp_path):
    p = str(tmp_path / "f.laz")
    with open(p, "wb") as f:
        f.write(b"LASF0000")
    with pytest.raises(pio.LoaderError, match="LAZ"):
        pio.load_points(p)
    # alike in both packages
    with pytest.raises(jax_io.LoaderError, match="LAZ"):
        jax_io.load_points(p)


def test_unsupported_format(tmp_path):
    p = str(tmp_path / "f.glb")
    with open(p, "wb") as f:
        f.write(b"x")
    with pytest.raises(pio.LoaderError, match="Unsupported"):
        pio.load_points(p)


def _ply_binary(pts):
    return (b"ply\nformat binary_little_endian 1.0\n"
            + f"element vertex {len(pts)}\n".encode()
            + b"property float x\nproperty float y\nproperty float z\n"
            b"end_header\n" + pts.astype("<f4").tobytes())


def test_ply_binary_little_endian(tmp_path, pts):
    p = tmp_path / "bin.ply"
    p.write_bytes(_ply_binary(pts))
    out = pio.load_points(str(p))
    np.testing.assert_allclose(out, pts, atol=1e-4)


def _pcd_header(n, mode):
    return (b"# .PCD v0.7\nVERSION 0.7\n"
            b"FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            + f"WIDTH {n}\nHEIGHT 1\nPOINTS {n}\n".encode()
            + f"DATA {mode}\n".encode())


def _pcd_lzf(pts):
    # literal-only runs (ctrl byte = len-1 < 32) are valid LZF, so the
    # fixture needs no compressor; body layout is SoA per the PCD spec
    soa = pts.astype("<f4").T.copy().tobytes()
    comp = b"".join(bytes([len(chunk) - 1]) + chunk
                    for chunk in (soa[i:i + 32]
                                  for i in range(0, len(soa), 32)))
    return (_pcd_header(len(pts), "binary_compressed")
            + np.asarray([len(comp), len(soa)], "<u4").tobytes() + comp)


def test_pcd_binary(tmp_path, pts):
    p = tmp_path / "bin.pcd"
    p.write_bytes(_pcd_header(len(pts), "binary")
                  + pts.astype("<f4").tobytes())
    out = pio.load_points(str(p))
    np.testing.assert_allclose(out, pts, atol=1e-4)


def test_pcd_binary_compressed_lzf(tmp_path, pts):
    p = tmp_path / "comp.pcd"
    p.write_bytes(_pcd_lzf(pts))
    out = pio.load_points(str(p))
    np.testing.assert_allclose(out, pts, atol=1e-4)


def test_pcd_binary_compressed_python_fallback(tmp_path, pts, monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    test_pcd_binary_compressed_lzf(tmp_path, pts)


# -- the cases of tests/test_native.py -----------------------------------------

@pytest.fixture
def needs_native():
    if not native.available():
        pytest.skip("g++ toolchain unavailable")


def test_native_builds_into_the_package(needs_native):
    lib = Path(native.get_lib()._name)
    assert lib.parent == REPO / "lidar_ai_recommendation_software_tpu_torch" \
        / "_build"


def test_text_parser_matches_python(needs_native):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-100, 100, (5000, 3))
    lines = ["# header"]
    for i, p in enumerate(pts):
        sep = [" ", ",", ";"][i % 3]
        lines.append(sep.join(f"{v:.6f}" for v in p))
        if i % 97 == 0:
            lines.append("garbage line")
    data = ("\n".join(lines) + "\n").encode()
    got = native.parse_xyz_text(data)
    np.testing.assert_allclose(got, pts, atol=1e-6)


def test_exponent_notation(needs_native):
    data = b"1.5e2 -2.5E-1 3e0\n"
    got = native.parse_xyz_text(data)
    np.testing.assert_allclose(got, [[150.0, -0.25, 3.0]])


def test_las_native_roundtrip(tmp_path, needs_native):
    rng = np.random.RandomState(1)
    pts = rng.uniform(-50, 50, (20000, 3))
    p = str(tmp_path / "cloud.las")
    pio.save_points(p, pts)
    out = pio.load_points(p)
    np.testing.assert_allclose(out, pts, atol=1e-5)


def test_large_text_uses_native_and_is_fast(tmp_path, needs_native):
    rng = np.random.RandomState(2)
    pts = rng.uniform(-100, 100, (200_000, 3))
    p = str(tmp_path / "big.xyz")
    pio.save_points(p, pts)
    t0 = time.time()
    out = pio.load_points(p)
    dt = time.time() - t0
    assert out.shape == (200_000, 3)
    np.testing.assert_allclose(out, pts, atol=1e-6)
    # native parses ~10M rows/s; 200k rows should be well under a second
    assert dt < 2.0, f"native text parse took {dt:.1f}s"


def test_fallback_without_native(monkeypatch):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    data = b"1 2 3\n4 5 6\n" * 10_000  # big enough to hit the native path
    pts = pio._load_text(data)
    assert pts.shape == (20_000, 3)


# -- both packages on the same bytes ---------------------------------------------

def _text_rows(pts, sep=" "):
    return "".join(sep.join(f"{v:.8f}" for v in p) + "\n" for p in pts)


def _file_bytes(fmt, pts, tmp_path):
    """The bytes of one file of ``pts`` per format; text bodies over 64
    KiB, so the native parser takes them when it is there."""
    if fmt == "csv":
        return ("x,y,z\n" + _text_rows(pts, ",")).encode()
    if fmt in ("xyz", "txt"):
        return ("# venue\n" + _text_rows(pts)).encode()
    if fmt in ("npy", "npz"):
        p = tmp_path / f"c.{fmt}"
        (np.save if fmt == "npy" else np.savez)(p, pts)
        return p.read_bytes()
    if fmt == "ply_ascii":
        return (f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n" + _text_rows(pts)).encode()
    if fmt == "ply_binary":
        return _ply_binary(pts)
    if fmt == "pcd_ascii":
        return _pcd_header(len(pts), "ascii") + _text_rows(pts).encode()
    if fmt == "pcd_binary":
        return _pcd_header(len(pts), "binary") + pts.astype("<f4").tobytes()
    if fmt == "pcd_lzf":
        return _pcd_lzf(pts)
    assert fmt == "las"
    p = tmp_path / "c.las"
    jax_io.save_points(str(p), pts)
    return p.read_bytes()


FORMATS = ("csv", "xyz", "txt", "npy", "npz", "ply_ascii", "ply_binary",
           "pcd_ascii", "pcd_binary", "pcd_lzf", "las")


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's parser built afresh into a directory of this
    module's own. Its build writes ``<cache>/libloader_<hash>.so.tmp``, the
    same name in every process, so test processes sharing the default
    cache can race, and the loser parses with NumPy from then on; here
    only this process builds there. The cache variable and the module's
    ``_LIB``/``_TRIED`` are restored at teardown."""
    mp = pytest.MonkeyPatch()
    mp.setenv("LIDAR_TPU_NATIVE_CACHE",
              str(tmp_path_factory.mktemp("jax_native")))
    mp.setattr(jax_native, "_LIB", None)
    mp.setattr(jax_native, "_TRIED", False)
    yield
    mp.undo()


@pytest.mark.parametrize("parser", ["native", "numpy"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_points_bit_equal_to_jax(tmp_path, monkeypatch, jax_native_lib,
                                      fmt, parser):
    """``load_points`` of both packages on the same bytes, bit for bit,
    with the native library (both packages' loaded: the JAX package's
    NumPy twin rounds three text formats apart) and (its ``get_lib`` gone
    in both packages) with the NumPy twins."""
    if parser == "native" and not native.available():
        pytest.skip("g++ toolchain unavailable")
    if parser == "native":
        assert jax_native.available(), "the JAX package's parser did not build"
    if parser == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    rng = np.random.RandomState(3)
    pts = rng.uniform(-60, 60, (5000, 3))
    data = _file_bytes(fmt, pts, tmp_path)
    ext = fmt.split("_")[0]
    got = pio.load_points(data, fmt=ext)
    want = jax_io.load_points(data, fmt=ext)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, pts, atol=1e-5)
    # and from a path, as the CLI reads it
    path = tmp_path / f"cloud.{ext}"
    path.write_bytes(data)
    np.testing.assert_array_equal(pio.load_points(str(path)), want)

