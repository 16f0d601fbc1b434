"""The port's tile picker (``repro_torch.kernels.autotune``) against JAX's.

With the ``TPU`` profile the port's model is JAX's: ``_causal_pairs``,
``_cost`` and ``sweep`` equal ``repro.kernels.autotune``'s over hd (64, 96,
128, 192, 256) x fp32 / int8 / int4 x S from 1 to 8192. Winner tables move
between the packages byte for byte. The ``H100`` profile's candidates are
the tiles ``csrc/flash_prefill.cu`` instantiates (read here from the
source), each within the 232,448 bytes of shared memory a block may use, and
the ``cuda`` legs resolve JAX's key format with the port's precision label.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import autotune as jat  # noqa: E402
from repro_torch.api import backends  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402

CU = Path(fp.__file__).resolve().parents[1] / "csrc" / "flash_prefill.cu"
HDS = (64, 96, 128, 192, 256)
PRECISIONS = ("fp32", "int8", "int4")
#: the source's Body enumerators -> autotune's tile families
FAMILY = {"TC_BF16": "tc", "TC_F32": "tc_f32", "QTC": "qtc", "Q4TC": "q4tc",
          "MLA": "tc_mla"}
ENV = ("REPRO_TILE_BQ", "REPRO_TILE_BK", "REPRO_AUTOTUNE_CACHE")


@pytest.fixture
def clean(monkeypatch):
    """Both packages' tables empty, no environment pin or cache, before and
    after the test."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    at.reset()
    jat.reset()
    yield
    at.reset()
    jat.reset()


def _pairs(lst):
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"Tile<(\d+), (\d+)>", lst))


def source_tiles():
    """{(family, width class): (block_q, block_k) pairs} of ``tc::TileSet``
    in the CUDA source: the primary template at the classes ``by_width``
    dispatches (64, 96, 128) of the three bodies, and each
    specialization."""
    src = CU.read_text()
    primary = re.search(r"struct TileSet \{\s*using type = Tiles<(.*?)>;",
                        src, flags=re.S).group(1)
    found = {(family, w): _pairs(primary)
             for family in ("tc", "tc_f32", "qtc", "q4tc")
             for w in (64, 96, 128)}
    for body, w, lst in re.findall(
            r"struct TileSet<Body::(\w+), (\d+)> \{\s*using type = "
            r"Tiles<(.*?)>;\s*\};", src, flags=re.S):
        found[(FAMILY[body], int(w))] = _pairs(lst)
    return found


# ------------------------------------------------------------------ #
# The TPU profile is JAX's model
# ------------------------------------------------------------------ #
def test_pow2_bucket_and_cache_key_equal_jax():
    for n in range(1, 8193):
        assert at.pow2_bucket(n) == jat.pow2_bucket(n)
    for args in (("cuda", "flash_prefill", 64, "bf16", 300),
                 ("pallas-tpu", "flash_q4prefill", 256, "int4", 8192),
                 ("cuda-tp", "flash_qprefill", 128, "int8", 1)):
        assert at.cache_key(*args) == jat.cache_key(*args)
    assert at.cache_key("cuda", "flash_prefill", 64, "bf16", 300) == \
        "cuda|flash_prefill|hd64|bf16|s512"


def test_causal_pairs_equal_jax():
    for s in range(1, 600):
        for bq in at.CANDIDATE_BQ:
            for bk in at.CANDIDATE_BK:
                assert at._causal_pairs(s, bq, bk) == \
                    jat._causal_pairs(s, bq, bk)
    assert (at.CANDIDATE_BQ, at.CANDIDATE_BK) == (jat.CANDIDATE_BQ,
                                                   jat.CANDIDATE_BK)


@pytest.mark.parametrize("hd", HDS)
def test_cost_equals_jax_bit_for_bit(hd):
    """``_cost`` at the TPU profile, float for float, at every candidate,
    at the buckets and at S values no bucket takes (the raw function)."""
    for precision in PRECISIONS:
        for s in (1, 7, 16, 100, 200, 256, 579, 1000, 2048, 8192):
            for bq in at.CANDIDATE_BQ:
                for bk in at.CANDIDATE_BK:
                    a = at._cost(s, bq, bk, hd, precision, at.TPU)
                    assert a == jat._cost(s, bq, bk, hd, precision)
                    assert a == at._cost(s, bq, bk, hd, precision)


@pytest.mark.parametrize("hd", HDS)
def test_sweep_equals_jax_over_the_grid(hd):
    """Both sweeps read S only through ``pow2_bucket`` (their first line),
    so each bucket from 16 to 8192 covers S from 1 to 8192: the buckets
    are compared, and every S up to 300 (the int4 hd256 edge at 200-256
    included) and a stride through the rest."""
    for precision in PRECISIONS:
        at_bucket = {}
        for b in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
            at_bucket[b] = at.sweep("pallas-tpu", "flash_prefill", hd,
                                    precision, b, profile=at.TPU)
            assert at_bucket[b] == jat.sweep("pallas-tpu", "flash_prefill",
                                             hd, precision, b)
        for s in (*range(1, 301), *range(301, 8193, 97), 8192):
            got = at.sweep("pallas-tpu", "flash_prefill", hd, precision, s,
                           profile=at.TPU)
            assert got == at_bucket[at.pow2_bucket(s)]
            if s <= 300 or s % 3 == 0:
                assert got == jat.sweep("pallas-tpu", "flash_prefill", hd,
                                        precision, s)


def test_tpu_profile_picks_what_jax_picks_at_the_edges():
    """Where JAX's model changes its mind: 128 x 128 at 579 positions at
    every hd, and (16, 16) for int4 at hd 256 and 200-256 positions."""
    for s in (200, 230, 256):
        assert at.sweep("x", "k", 256, "int4", s, profile=at.TPU) == \
            jat.sweep("x", "k", 256, "int4", s) == (16, 16)
    for hd in (64, 96, 128, 192, 256):
        assert at.sweep("x", "k", hd, "fp32", 579, profile=at.TPU) == \
            (128, 128)


# ------------------------------------------------------------------ #
# Tables move between the packages byte for byte
# ------------------------------------------------------------------ #
def test_jax_table_loads_and_reserializes_byte_for_byte(tmp_path, clean):
    keys = [("pallas-interpret", "flash_prefill", 64, "fp32", 512),
            ("pallas-tpu", "flash_qprefill", 128, "int8", 2048),
            ("pallas-tpu", "flash_q4prefill", 256, "int4", 230),
            ("cuda", "flash_prefill", 96, "fp32", 579)]
    for key in keys:
        jat.tile_config(*key)
    path = tmp_path / "jax_winners.json"
    jat.save_table(str(path))
    assert at.load_table(str(path)) == len(keys)
    assert at.serialize_table() == path.read_text()
    # the other way: the port's cuda winners into JAX
    at.reset()
    for key in (("cuda", "flash_prefill", 64, "bf16", 300),
                ("cuda", "flash_qprefill", 128, "int8", 64),
                ("cuda", "flash_prefill", 192, "bf16", 1024)):
        at.tile_config(*key)
    back = tmp_path / "torch_winners.json"
    at.save_table(str(back))
    jat.reset()
    assert jat.load_table(str(back)) == 3
    assert jat.serialize_table() == back.read_text()


def test_env_cache_preloads_winners(tmp_path, monkeypatch, clean):
    path = tmp_path / "winners.json"
    path.write_text('{"schema_version": 1, "winners": '
                    '{"cuda|flash_prefill|hd64|bf16|s512": [128, 32]}}')
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert at.tile_config("cuda", "flash_prefill", 64, "bf16", 300) == \
        (128, 32)
    assert at.winner_table() == {"cuda|flash_prefill|hd64|bf16|s512":
                                 (128, 32)}


# ------------------------------------------------------------------ #
# Twins of JAX's autotuner tests (tests/test_flash_prefill.py), cuda keys
# ------------------------------------------------------------------ #
def test_autotune_deterministic_and_roundtrips(tmp_path, monkeypatch, clean):
    keys = [("cuda", "flash_prefill", 64, "bf16", 512),
            ("cuda", "flash_qprefill", 64, "int8", 512),
            ("cuda", "flash_q4prefill", 64, "int4", 512),
            ("cuda", "flash_prefill", 128, "fp32", 2048),
            ("cuda", "flash_prefill", 192, "bf16", 1024)]
    t1 = [at.tile_config(*k) for k in keys]
    s1 = at.serialize_table()
    at.reset()
    t2 = [at.tile_config(*k) for k in keys]
    assert t1 == t2
    assert at.serialize_table() == s1            # byte-identical rerun

    path = str(tmp_path / "winners.json")
    at.save_table(path)
    at.reset()
    assert at.load_table(path) == len(keys)
    assert at.serialize_table() == s1            # save/load roundtrip

    # precedence: in-code pin beats the cached winner...
    at.pin(*keys[0], 128, 32)
    assert at.tile_config(*keys[0]) == (128, 32)
    assert "cuda|flash_prefill|hd64|bf16|s512" not in {
        k for k, v in at.winner_table().items() if v == (128, 32)}
    # ...and the env pin beats everything
    monkeypatch.setenv("REPRO_TILE_BQ", "64")
    monkeypatch.setenv("REPRO_TILE_BK", "128")
    assert at.tile_config(*keys[0]) == (64, 128)
    assert at.tile_config(*keys[3]) == (64, 128)


def test_autotune_seq_buckets_share_keys():
    """Seq lens in the same pow2 bucket resolve to one cache key (one
    sweep, one table entry), different buckets to different keys."""
    a = at.cache_key("cuda", "flash_prefill", 64, "bf16", 300)
    b = at.cache_key("cuda", "flash_prefill", 64, "bf16", 512)
    c = at.cache_key("cuda", "flash_prefill", 64, "bf16", 513)
    assert a == b
    assert b != c


# ------------------------------------------------------------------ #
# The H100 profile: the instantiated tiles, within shared memory
# ------------------------------------------------------------------ #
def test_tiles_are_the_sources_instantiations():
    found = source_tiles()
    assert found == dict(at.TILES)
    # the tile of old in every class of the three bodies, flash_mla's one
    for (family, w), tiles in found.items():
        assert (at.MLA_TILE if family == "tc_mla" else at.DEFAULT_TILE) \
            in tiles, (family, w)
    assert found[("tc_mla", 192)] == (at.MLA_TILE,) == ((128, 128),)
    src = " ".join(CU.read_text().split())
    assert "static_assert(mla::BM == 128 && mla::BK == 128" in src
    # 16 rows a warp, BR / 16 warps of 32 threads
    assert src.count("__launch_bounds__(2 * BR)") == 3


def test_every_candidate_fits_shared_memory():
    """Each instantiated tile's dynamic shared memory (the mirror of the
    source's smem_bytes / qtc_smem_bytes / q4tc_smem_bytes) at its class's
    widest rows, for both q dtypes of each body, is at most 232,448."""
    checked = 0
    for (family, w), tiles in at.TILES.items():
        bodies = {"tc": ("tc",), "tc_f32": ("tc_f32",),
                  "qtc": ("qtc", "qtc_f32"), "q4tc": ("q4tc", "q4tc_f32"),
                  "tc_mla": ("tc_mla",)}[family]
        dv = 128 if w == 192 else w
        for body in bodies:
            for bq, bk in tiles:
                assert at.smem_bytes(body, w, dv, bq, bk) <= at.SMEM_LIMIT \
                    == 232448
                checked += 1
    assert checked == 4 * 3 * (2 + 2 * 2) + 3
    # 128-key tiles of the f32 body would not fit at 128
    assert at.smem_bytes("tc_f32", 128, 128, 64, 128) > at.SMEM_LIMIT
    assert at.smem_bytes("tc_f32", 128, 128, 128, 128) > at.SMEM_LIMIT
    # the tile of old, by the source's formula: Q [64][72] bf16, a 2-stage
    # ring of 64-key K and V rows of 72 bf16, or the f32 epilogue [64][72]
    assert at.smem_bytes("tc", 64, 64, 64, 64) == max(
        2 * 64 * 72 + 2 * 2 * 64 * (72 + 72), 4 * 64 * 72)


def test_sweep_excludes_tiles_over_the_budget():
    tight = at.Profile(**{**at.H100.__dict__, "budget": 60000})
    for s in (16, 256, 4096):
        bq, bk = at.sweep("cuda", "flash_prefill", 128, "bf16", s, tight)
        assert at.smem_bytes("tc", 128, 128, bq, bk) <= 60000
    with pytest.raises(ValueError, match="no candidate tile fits"):
        at.sweep("cuda", "flash_prefill", 128, "bf16", 256,
                 at.Profile(**{**at.H100.__dict__, "budget": 1000}))
    with pytest.raises(ValueError, match="no CUDA body"):
        at.sweep("cuda", "paged_q4decode", 64, "int4", 512)


def test_every_h100_winner_is_instantiated():
    found = source_tiles()
    for kernel, precisions in (("flash_prefill", ("bf16", "fp32")),
                               ("flash_qprefill", ("int8",)),
                               ("flash_q4prefill", ("int4",))):
        hds = (32, 64, 96, 128, 192) if kernel == "flash_prefill" \
            else (32, 64, 96, 128)
        for precision in precisions:
            for hd in hds:
                body = at.h100_body(kernel, precision, hd)
                for s in (1, 37, 64, 200, 255, 300, 579, 600, 1024, 8192):
                    tile = at.sweep("cuda", kernel, hd, precision, s)
                    assert tile in found[(body, at.width(hd))], (
                        kernel, precision, hd, s, tile)


# ------------------------------------------------------------------ #
# The cuda legs and the wrappers
# ------------------------------------------------------------------ #
def _leg_recorder(monkeypatch):
    """The cuda legs with the card check off and each kernel entry
    replaced by a recorder of its tile (nothing launches on the CPU)."""
    calls = []
    monkeypatch.setattr(backends, "_on_card", lambda primitive, t: None)
    for name in ("flash_prefill", "flash_qprefill", "flash_q4prefill"):
        monkeypatch.setattr(
            backends._fp, name,
            lambda *a, _n=name, **kw: calls.append((_n, kw["block_q"],
                                                    kw["block_k"])))
    return calls


def test_cuda_legs_resolve_the_documented_key(monkeypatch, clean):
    calls = _leg_recorder(monkeypatch)
    cuda = backends.get_backend("cuda")
    q = torch.zeros((1, 300, 4, 64), dtype=torch.bfloat16)
    cuda.flash_prefill(q, q[:, :, :2], q[:, :, :2])
    cuda.flash_prefill(q.float(), q.float()[:, :, :2], q.float()[:, :, :2])
    q8 = torch.zeros((1, 40, 4, 128))
    cuda.flash_qprefill(q8, None, None, None, None)
    cuda.flash_q4prefill(q8, None, None, None, None)
    # cuda-tp delegates: its key is the inner backend's
    backends.get_backend("cuda-tp").flash_prefill(q, q, q)
    want = {"cuda|flash_prefill|hd64|bf16|s512",
            "cuda|flash_prefill|hd64|fp32|s512",
            "cuda|flash_qprefill|hd128|int8|s64",
            "cuda|flash_q4prefill|hd128|int4|s64"}
    assert set(at.winner_table()) == want
    table = at.winner_table()
    assert calls == [
        ("flash_prefill", *table["cuda|flash_prefill|hd64|bf16|s512"]),
        ("flash_prefill", *table["cuda|flash_prefill|hd64|fp32|s512"]),
        ("flash_qprefill", *table["cuda|flash_qprefill|hd128|int8|s64"]),
        ("flash_q4prefill", *table["cuda|flash_q4prefill|hd128|int4|s64"]),
        ("flash_prefill", *table["cuda|flash_prefill|hd64|bf16|s512"])]
    assert cuda.flash_tile("flash_prefill", q) == \
        table["cuda|flash_prefill|hd64|bf16|s512"]
    # the ref legs take no tile
    assert backends.get_backend("ref").flash_prefill(
        q.float(), q.float(), q.float()).shape == (1, 300, 4, 64)


def test_cuda_leg_passes_an_env_pin_on(monkeypatch, clean):
    calls = _leg_recorder(monkeypatch)
    monkeypatch.setenv("REPRO_TILE_BQ", "128")
    monkeypatch.setenv("REPRO_TILE_BK", "32")
    q = torch.zeros((2, 100, 8, 96), dtype=torch.bfloat16)
    backends.get_backend("cuda").flash_prefill(q, q, q)
    assert calls == [("flash_prefill", 128, 32)]
    assert at.winner_table() == {}


def test_uninstantiated_pair_raises_before_any_launch(monkeypatch, clean):
    """Through the cuda leg (an env pin no body has) and the wrappers
    directly: ValueError before the library is built or a kernel named."""
    def no_launch(*a, **kw):
        raise AssertionError("a kernel was reached")

    monkeypatch.setattr(_build, "function", no_launch)
    monkeypatch.setattr(_build, "library", no_launch)
    monkeypatch.setattr(backends, "_on_card", lambda primitive, t: None)
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    launches = fp.flash_prefill.launches
    monkeypatch.setenv("REPRO_TILE_BQ", "48")
    monkeypatch.setenv("REPRO_TILE_BK", "48")
    with pytest.raises(ValueError, match="not instantiated"):
        backends.get_backend("cuda").flash_prefill(q, q, q)
    monkeypatch.delenv("REPRO_TILE_BQ")
    monkeypatch.delenv("REPRO_TILE_BK")
    for bad in ((48, 48), (256, 64), (64, 256), (32, 32)):
        with pytest.raises(ValueError, match="not instantiated"):
            fp.flash_prefill(q, q, q, block_q=bad[0], block_k=bad[1])
    # the f32 body at 128 has no 128-key tile (shared memory); MLA one tile
    q128 = torch.zeros((1, 64, 2, 128))
    with pytest.raises(ValueError, match="tc_f32"):
        fp.flash_prefill(q128, q128, q128, block_q=128, block_k=128)
    qm = torch.zeros((1, 64, 2, 192), dtype=torch.bfloat16)
    vm = torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tc_mla"):
        fp.flash_prefill(qm, qm, vm, block_q=64, block_k=64)
    k_i8 = torch.zeros((1, 64, 4, 64), dtype=torch.int8)
    s8 = torch.ones((1, 64, 4))
    with pytest.raises(ValueError, match="qtc"):
        fp.flash_qprefill(q, k_i8, s8, k_i8, s8, block_q=96, block_k=64)
    k_i4 = torch.zeros((1, 64, 4, 32), dtype=torch.int8)
    s4 = torch.ones((1, 64, 4, 2), dtype=torch.float16)
    with pytest.raises(ValueError, match="q4tc"):
        fp.flash_q4prefill(q, k_i4, s4, k_i4, s4, block_q=64, block_k=16)
    assert fp.flash_prefill.launches == launches


def test_wrapper_tiles_default_and_count_keys():
    assert fp.tile_for("tc", 64, 64) == at.DEFAULT_TILE == (64, 64)
    assert fp.tile_for("tc", 64, 64, block_q=128) == (128, 64)
    assert fp.tile_for(fp.MLA_BODY, 192, 128) == at.MLA_TILE
    assert fp.tile_for("tc", 150, 64) == (64, 64)     # unaligned MLA rows
    assert fp.tile_for("q4tc_f32", 96, 96, 128, 32) == (128, 32)
    # every instantiated tile has a counter, and only those
    for wrapper, bodies in ((fp.flash_prefill, fp.BODIES),
                            (fp.flash_qprefill, fp.QBODY.values()),
                            (fp.flash_q4prefill, fp.Q4BODY.values())):
        want = {f"{b}:{bq}x{bk}" for b in bodies for w in (64, 96, 128, 192)
                for bq, bk in at.tiles(b, w)}
        assert set(wrapper.launches_by_tile) == want
    # the CPU takes the plain version at any instantiated tile, unchanged
    q = torch.randn((1, 70, 4, 64), generator=torch.Generator().manual_seed(0))
    a = fp.flash_prefill(q, q, q)
    b = fp.flash_prefill(q, q, q, block_q=128, block_k=32)
    assert torch.equal(a, b)
    assert sum(fp.flash_prefill.launches_by_tile.values()) == 0
