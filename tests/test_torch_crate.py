"""The port's USD crate (.usdc) codec and reader against the JAX package's.

The port keeps its own copies of `loaders/lz4.py`, `loaders/crate.py` and
`native/crate_codec.cpp` (built with g++ at first use into
strelka_tpu_torch/_build/native/<hash>/). These tests hold them equal to
the JAX package's, exactly (bytes and integers, no tolerance):

(a) LZ4 block and pxr framing: round trips, and the port decoding what the
    JAX package compressed (and the reverse);
(b) pxr integer coding: round trips, and the hand-built pxr fixtures of
    tests/test_crate.py decoded equal to the JAX decoder; where g++ is
    present the native decode and the Python one agree on each;
(c) `read_usdc` on kitchen.usdc and on stages written by the JAX
    `write_usdc` and by the port's: the same Prim trees as the JAX reader's,
    and the two writers' files byte-identical;
(d) garbage, truncated, wrong-version and byte-flipped files raise
    ValueError where the JAX reader raises it, and parse where it parses.
"""

import struct

import numpy as np
import pytest

from strelka_tpu.loaders import crate as JC
from strelka_tpu.loaders import lz4 as JLZ
from strelka_tpu.loaders.usda_parser import parse_usda as jax_parse_usda
from strelka_tpu_torch import native
from strelka_tpu_torch.loaders import crate as TC
from strelka_tpu_torch.loaders import lz4 as TLZ
from strelka_tpu_torch.loaders.usda_parser import parse_usda
from strelka_tpu_torch.scene.kitchen import ensure_kitchen

from test_crate import _ANIM_STAGE, _VARIANT_STAGE
from test_crate_fixture import build_fixture, build_variant_fixture
from test_torch_usd import COFFEETABLE, STAGES, same

_RNG_CASES = [
    b"",
    b"a",
    b"hello world " * 100,
    ("random", 10_000, 256),
    ("random", 50_000, 4),  # compressible
    b"\x00" * 100_000,
    b"A" * 5000 + b"pattern" * 800 + b"B" * 3,  # matches past the 15+255 extension steps
]


def _bytes(case, seed):
    if isinstance(case, bytes):
        return case
    _, n, hi = case
    return bytes(np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint8))


@pytest.mark.parametrize("case", range(len(_RNG_CASES)))
def test_lz4_matches_jax(case):
    data = _bytes(_RNG_CASES[case], case)
    comp = TLZ.lz4_block_compress(data)
    assert comp == JLZ.lz4_block_compress(data)
    assert TLZ.lz4_block_decompress(comp, len(data)) == data
    framed = TLZ.fast_compress(data)
    assert framed == JLZ.fast_compress(data)
    assert TLZ.fast_decompress(framed, len(data)) == data == JLZ.fast_decompress(framed, len(data))


def _pxr_fixture(wide: bool):
    """tests/test_crate.py's hand-built pxr streams (integerCoding.cpp):
    common delta, 2-bit codes LSB-first, then the explicit deltas, one size
    up in the 64-bit codec."""
    if wide:
        vals = [7, 14, 21, 321, 321 + 2**20, 321 + 2**20 + 2**40]
        head, parts = struct.pack("<q", 7), struct.pack("<h", 300) + struct.pack("<i", 2**20) + struct.pack("<q", 2**40)
    else:
        vals = [5, 10, 15, 115, 115 + 2**10, 115 + 2**10 + 2**20]
        head, parts = struct.pack("<i", 5), struct.pack("<b", 100) + struct.pack("<h", 2**10) + struct.pack("<i", 2**20)
    codes = [0, 0, 0, 1, 2, 3]
    cb = bytearray((len(codes) * 2 + 7) // 8)
    for i, c in enumerate(codes):
        cb[i >> 2] |= c << ((i & 3) * 2)
    return vals, head + bytes(cb) + parts


@pytest.mark.parametrize("wide", [False, True])
def test_integer_pxr_fixture_matches_jax(wide):
    vals, buf = _pxr_fixture(wide)
    port = TC._decode_ints(buf, len(vals), wide=wide)
    np.testing.assert_array_equal(port, JC._decode_ints(buf, len(vals), wide=wide))
    np.testing.assert_array_equal(port, np.asarray(vals, np.int64))
    assert TC._encode_ints(vals, wide=wide) == buf == JC._encode_ints(vals, wide=wide)


def _int_cases():
    rng = np.random.default_rng(1)
    return [
        ([], False), ([0], False), ([5, 5, 5, 5], False), (list(range(1000)), False),
        ([int(v) for v in rng.integers(-(2**30), 2**30, 500)], False),
        ([0, 1, -1, 127, -128, 32767, -32768, 2**30, -(2**30)], False),
        ([0, 2**40, -(2**40), 7, 7, 7], True),
        ([int(v) for v in rng.integers(-(2**50), 2**50, 300)], True),
    ]


@pytest.mark.parametrize("case", range(8))
def test_integer_coding_matches_jax(case):
    vals, wide = _int_cases()[case]
    enc = TC._encode_ints(vals, wide=wide)
    assert enc == JC._encode_ints(vals, wide=wide)
    np.testing.assert_array_equal(TC._decode_ints(enc, len(vals), wide=wide), np.asarray(vals, np.int64))


@pytest.fixture
def python_decoders(monkeypatch):
    """The port's crate reader with its native decoders switched off: every
    native entry returns None and the Python loops decode."""
    monkeypatch.setattr(native, "get_library", lambda: None)


def test_python_lz4_decoder_matches(python_decoders):
    for case in range(len(_RNG_CASES)):
        data = _bytes(_RNG_CASES[case], case)
        assert TLZ.fast_decompress(JLZ.fast_compress(data), len(data)) == data


def test_native_decoders_agree_with_python():
    """Where g++ is present: the port's native LZ4 and integer decoders give
    what the Python decoders give, and reject a malformed block."""
    if native.get_library() is None:
        pytest.skip("no g++: the crate reader decodes in Python, which the other tests hold")
    for case in range(len(_RNG_CASES)):
        data = _bytes(_RNG_CASES[case], case)
        comp = TLZ.lz4_block_compress(data)
        assert native.native_lz4_decompress(comp, len(data)) == data
        assert native.native_lz4_decompress_lenient(comp, len(data) + 64) == data
    streams = [(TC._encode_ints(vals, wide=wide), len(vals), wide) for vals, wide in _int_cases()]
    streams += [(buf, len(vals), wide) for wide in (False, True) for vals, buf in [_pxr_fixture(wide)]]
    for buf, n, wide in streams:
        np.testing.assert_array_equal(native.native_int_decode(buf, n, wide), TC._decode_ints(buf, n, wide))
    with pytest.raises(ValueError):
        native.native_lz4_decompress(b"\xf0\xff", 100)


def _trees_equal(path):
    same(JC.read_usdc(path), TC.read_usdc(path), "root")


def test_kitchen_tree_matches_jax():
    _trees_equal(ensure_kitchen())


def test_kitchen_tree_python_decoders(python_decoders):
    """The Python decoders give the tree the JAX reader gives (the JAX
    reader takes its own native library where g++ is present)."""
    _trees_equal(ensure_kitchen())


def _stage_texts():
    texts = {name: files[main] for name, (files, main) in STAGES.items()
             if name not in ("references", "sublayers")}  # flattened stages: the writer's scope
    texts["anim"] = _ANIM_STAGE
    texts["variants"] = _VARIANT_STAGE
    with open(COFFEETABLE) as f:
        texts["coffeetable"] = f.read()
    return texts


@pytest.mark.parametrize("name", sorted(_stage_texts()))
def test_written_stages_match_jax(tmp_path, name):
    """Both writers write the same bytes; both readers read back the same
    tree from the JAX writer's file and from the port's."""
    text = _stage_texts()[name]
    jax_path, port_path = str(tmp_path / "jax.usdc"), str(tmp_path / "port.usdc")
    JC.write_usdc(jax_path, jax_parse_usda(text))
    TC.write_usdc(port_path, parse_usda(text))
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    _trees_equal(jax_path)
    _trees_equal(port_path)


@pytest.mark.parametrize("builder", [build_fixture, build_variant_fixture])
def test_independent_fixtures_match_jax(tmp_path, builder):
    """tests/test_crate_fixture.py's stages, encoded byte by byte without the
    writer (uncompressed arrays, widest deltas, another section order)."""
    path = str(tmp_path / "fixture.usdc")
    with open(path, "wb") as f:
        f.write(builder())
    _trees_equal(path)


def _outcome(read, path):
    try:
        return ("tree", read(path))
    except ValueError as e:
        return ("ValueError", str(e))


def _same_outcome(path):
    ja, tp = _outcome(JC.read_usdc, path), _outcome(TC.read_usdc, path)
    assert ja[0] == tp[0], (ja[0], tp[0])
    if ja[0] == "tree":
        same(ja[1], tp[1], "root")
    return tp[0]


def test_bad_files_raise_as_jax(tmp_path):
    """Garbage, an old version, and truncations of a written stage: the
    port raises ValueError exactly where the JAX reader does (and both
    raise on the first two)."""
    garbage = tmp_path / "garbage.usdc"
    garbage.write_bytes(b"NOT-USDC" + b"\x00" * 100)
    old = tmp_path / "old.usdc"
    old.write_bytes(b"PXR-USDC" + bytes([0, 3, 0]) + b"\x00" * 80)
    for p in (garbage, old):
        assert _same_outcome(str(p)) == "ValueError"
        with pytest.raises(ValueError):
            TC.read_usdc(str(p))
    whole = str(tmp_path / "whole.usdc")
    TC.write_usdc(whole, parse_usda(STAGES["structure"][0]["stage.usda"]))
    data = open(whole, "rb").read()
    for cut in (16, 80, 88, len(data) // 3, len(data) - 7):
        p = tmp_path / f"cut_{cut}.usdc"
        p.write_bytes(data[:cut])
        _same_outcome(str(p))


@pytest.mark.parametrize("builder", [build_fixture, build_variant_fixture])
def test_byteflip_fuzz_as_jax(tmp_path, builder):
    """32 seeded single-byte flips of each independent fixture: each parses
    to the JAX reader's tree or raises ValueError where it raises."""
    blob = bytearray(builder())
    rng = np.random.default_rng(2024)
    path = str(tmp_path / "fuzz.usdc")
    outcomes = set()
    for _ in range(32):
        i = int(rng.integers(0, len(blob)))
        orig = blob[i]
        blob[i] ^= int(rng.integers(1, 256))
        with open(path, "wb") as f:
            f.write(blob)
        outcomes.add(_same_outcome(path))
        blob[i] = orig
    assert outcomes  # each flip checked; typically both kinds occur
