"""The port's FIR bank (kernel F1, ops/cuda_fir.py and csrc/fir_bank.cu) on
the CPU.

F1 is not a TPU kernel: the JAX package leaves the bank to XLA
(gstpeaq_tpu/ops/fb_ear.py::filter_bank_t).  Here the host plan is held to
the conv weight it packs, bit for bit; the kernel's grid and store map,
re-enacted from its source's constants, to write each output once at every
shape the port gives it, up to the one-hour one shot with its 64-bit
offsets; the kernel's arithmetic, re-enacted in numpy over its staged
strip, to the plain version; and the plain version, with and without a
history, to JAX filter_bank_t in float64 within 1e-12.  The CUDA kernel
itself is held against its plain version on the card by chip_smoke.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gstpeaq_tpu import earparams as JEP
from gstpeaq_tpu.ops import fb_ear as JFB
from gstpeaq_tpu_torch import earparams as EP
from gstpeaq_tpu_torch.ops import _build
from gstpeaq_tpu_torch.ops import cuda_fir
from gstpeaq_tpu_torch.ops import fb_ear as FB

BANDS = cuda_fir.BANDS
SUB = cuda_fir.SUB
HOUR = (4, 60 * 60 * 48000)
# the shapes [rows, T] the port gives F1: one pair; the advanced batch
# (32 pairs of 10 s stereo, both signals); the chunk-64 and chunk-1,024 FB
# steps at one stream and at 16; the one-hour one shot; and edges: one
# instant, one row, instant counts off a tile of either dtype
SHAPES = [(4, 480000), (128, 491520), (4, 196608), (64, 196608),
          (4, 3145728), (64, 3145728), HOUR, (1, 32), (1, 32 * 129),
          (3, 32 * 513), (2, 32 * 1000)]
DTYPES = (torch.float32, torch.float64)


@pytest.fixture(scope="module")
def taps():
    return FB.folded_taps(EP.fb_ear_params())


def fir_source() -> str:
    return (_build.CSRC / "fir_bank.cu").read_text()


def kernel_constants() -> dict:
    """csrc/fir_bank.cu's layout constants."""
    src = fir_source()
    out = {name: int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
           for name in ("kSub", "kFirPad", "kBands", "kGroupBands",
                        "kKAlign", "kThreads", "kPerThread", "kMmaRows",
                        "kChunk", "kMaxParts")}
    for name in ("kTileInstants", "kSkew", "kMinBlocks"):
        m = re.search(rf"constexpr int {name} = sizeof\(T\) == 4 \? (\d+) "
                      r": (\d+);", src)
        out[name] = {torch.float32: int(m[1]), torch.float64: int(m[2])}
    assert "constexpr int kStripRow = kSub + kSkew<T>;" in src
    return out


def unpack(plan) -> np.ndarray:
    """The packed weights scattered back to each channel's offsets j,
    [80, 32 x 47] (zeros where the plan holds nothing)."""
    full = np.zeros((2 * BANDS, SUB * cuda_fir.FIR_BLOCKS))
    for g in range(plan.groups):
        k = plan.hi[g] - plan.lo[g]
        w = plan.weights[plan.offset[g]:plan.offset[g] + 8 * k].reshape(k, 8)
        full[cuda_fir.group_channels(g), plan.lo[g]:plan.hi[g]] = w.T
    return full


def random_taps(rng) -> np.ndarray:
    """Taps with windows of random placement and length per channel, one
    channel all zero and one group all zero."""
    taps = np.zeros((2 * BANDS, cuda_fir.TAPS))
    for c in range(2 * BANDS):
        if c in (7, 12, 13, 14, 15, 52, 53, 54, 55):
            continue
        a, b = np.sort(rng.integers(0, cuda_fir.TAPS, 2))
        taps[c, a:b + 1] = rng.standard_normal(b + 1 - a)
    return taps


@pytest.mark.parametrize("which", ["peaq", "random"])
def test_plan_packs_the_conv_weight_bit_for_bit(taps, which):
    """The packed group weights, scattered back, are fb_ear.fir_weight
    bit for bit, and every weight the plan leaves out, or pads a group's
    window with, is exactly 0; the windows come from the taps: each
    channel's from its first to its last nonzero lag, band 0's the whole
    0..1455 (it carries the folded lag-1456 tap at lag 0)."""
    if which == "random":
        taps = random_taps(np.random.default_rng(5))
    plan = cuda_fir.fir_plan(taps)
    want = FB.fir_weight(taps)                            # [80, 32, 47]
    full = unpack(plan)
    got = full.reshape(2 * BANDS, cuda_fir.FIR_BLOCKS, SUB).transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    j = np.arange(full.shape[1])
    inside = ((j >= plan.channel_lo[:, None])
              & (j < plan.channel_hi[:, None]))
    covered = np.zeros_like(inside)
    for g in range(plan.groups):
        covered[cuda_fir.group_channels(g), plan.lo[g]:plan.hi[g]] = True
    assert np.all(covered[inside])
    flat = want.transpose(0, 2, 1).reshape(2 * BANDS, -1)
    assert np.all(flat[~covered] == 0.0) and np.all(full[~inside] == 0.0)
    assert np.all(plan.lo % cuda_fir.K_ALIGN == 0)
    assert np.all(plan.hi % cuda_fir.K_ALIGN == 0)
    assert plan.jbase % SUB == 0 and np.all(plan.lo >= plan.jbase)
    work = plan.hi - plan.lo
    for p, table in enumerate(plan.tables, 1):
        order, start = plan.parts(p)
        np.testing.assert_array_equal(table, np.concatenate(
            [[plan.jbase], plan.lo, plan.hi, plan.offset, [p], order,
             start]))
        assert sorted(order) == list(range(plan.groups))
        assert start[0] == 0 and start[-1] == plan.groups
        assert np.all(np.diff(start) > 0)
        loads = [work[order[a:b]].sum() for a, b in zip(start, start[1:])]
        assert max(loads) - min(loads) <= work.max()
    if which == "peaq":
        assert (plan.channel_lo[0], plan.channel_hi[0]) == (
            cuda_fir.FIR_PAD - cuda_fir.TAPS + 1, cuda_fir.FIR_PAD + 1)
        # the bound's count and the work the kernel does, an instant
        width = plan.channel_hi - plan.channel_lo
        assert width.sum() == 43578
        assert 8 * (plan.hi - plan.lo).sum() == 48096
        assert plan.weights.size == 48096


def test_plan_is_cached_and_read_only(taps):
    plan = cuda_fir.fir_plan(taps)
    assert cuda_fir.fir_plan(taps.copy()) is plan
    with pytest.raises(ValueError):
        plan.weights[0] = 1.0
    k = FB.build_consts(EP.fb_ear_params(), torch.float32)
    assert k.fir_plan is plan
    # the packed weights are the wrapper's, cached per (plan, dtype,
    # device), so that their layout follows the dtype they are read in:
    # consts cast to another dtype carry no packed weights of the old one
    assert not any("pack" in name for name, _ in k.named_buffers())
    packed = cuda_fir.packed_weight(plan, torch.float32, "cpu")
    assert cuda_fir.packed_weight(plan, torch.float32, "cpu") is packed
    assert packed.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(),
                                  plan.weights.astype(np.float32))
    double = cuda_fir.packed_weight(plan, torch.float64, "cpu")
    assert double.dtype == torch.float64
    assert not np.array_equal(double.numpy(), plan.weights)


def test_double_weights_are_in_fragment_order(taps):
    """In float64 the packed weights are read as mma B fragments: lane l
    of k-step s reads value 32 s + l, which is tap 4 s + l % 4 of channel
    l // 4."""
    plan = cuda_fir.fir_plan(taps)
    packed = cuda_fir.packed_weight(plan, torch.float64, "cpu").numpy()
    rows = plan.weights.reshape(-1, 8)                 # [taps, 8]
    lane = np.arange(32)
    for s in range(len(rows) // 4):
        np.testing.assert_array_equal(packed[32 * s + lane],
                                      rows[4 * s + lane % 4, lane // 4])


def test_plan_constants_are_the_kernels():
    """The wrapper's copies of fir_bank.cu's constants, and the kernel's C
    entries in _build.SIGNATURES."""
    k = kernel_constants()
    assert k["kSub"] == SUB and k["kFirPad"] == cuda_fir.FIR_PAD
    assert k["kBands"] == BANDS and k["kGroupBands"] == cuda_fir.GROUP_BANDS
    assert k["kKAlign"] == cuda_fir.K_ALIGN
    assert k["kTileInstants"] == cuda_fir.TILE_INSTANTS
    assert k["kSkew"] == cuda_fir.SKEW
    assert k["kChunk"] == cuda_fir.CHUNK
    assert k["kMaxParts"] == cuda_fir.MAX_PARTS
    assert "constexpr int kChunkValues = kChunk * kGroupChannels;" in \
        fir_source()
    # the blocks an SM holds, as the wrapper's grid counts them, are those
    # the kernel's registers are bounded for
    plan = cuda_fir.fir_plan(FB.folded_taps(EP.fb_ear_params()))
    for dtype in DTYPES:
        smem = cuda_fir.launch_grid(1, SUB, dtype, plan, 1)[-1]
        held = cuda_fir.SM_SHARED // (smem + cuda_fir.BLOCK_RESERVED)
        assert held == k["kMinBlocks"][dtype]
    for suffix in ("f32", "f64"):
        assert len(_build.SIGNATURES[f"peaq_fir_bank_{suffix}"]) == 12


def block_stores(dtype, i0: int, n_inst: int, groups) -> np.ndarray:
    """One block's stores (fir_bank.cu's store_f64 / store_f32
    re-enacted) of `groups` at tile start i0 of a row of n_inst instants:
    [stores, 2] of (channel, part x 40 + band, and instant), the masked
    ones dropped."""
    k = kernel_constants()
    gb = k["kGroupBands"]
    tid = np.arange(k["kThreads"])
    stores = []
    for grp in groups:
        if dtype == torch.float64:
            warp, lane = tid >> 5, tid & 31
            g, t = lane >> 2, lane & 3
            pairs = [(2 * t + e, i0 + k["kSub"] * warp + k["kMmaRows"] * m + g)
                     for e in range(2) for m in range(k["kPerThread"])]
        else:
            pairs = [(np.full_like(tid, ch), i0 + tid + k["kThreads"] * r)
                     for ch in range(2 * gb) for r in range(k["kPerThread"])]
        ch = np.concatenate([c for c, _ in pairs])
        i = np.concatenate([i for _, i in pairs])
        channel = ch // gb * BANDS + gb * grp + ch % gb
        live = i < n_inst
        stores.append(np.stack([channel[live], i[live]], 1))
    return np.concatenate(stores)


def store_counts(stores: np.ndarray, i0: int, n: int) -> np.ndarray:
    counts = np.zeros((2 * BANDS, n), np.int64)
    np.add.at(counts, (stores[:, 0], stores[:, 1] - i0), 1)
    return counts


def tile_stores(dtype, i0: int, n_inst: int, plan, parts: int):
    """The stores of a tile's blocks, one per part of the groups."""
    order, start = plan.parts(parts)
    return np.concatenate([block_stores(dtype, i0, n_inst, order[a:b])
                           for a, b in zip(start, start[1:])])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_fir_tiles_store_each_value_once(taps, shape, dtype):
    """F1's grid (cuda_fir.launch_grid on an H100's 132 SMs, and the
    kernel's block -> (row, tile, part) map): every (row, tile, part) one
    block; a tile's blocks store each of its (channel, instant) slots
    once, the last tile's only those before the row's end, and every other
    tile is tile 0 moved by its start; so each output of re and im
    [rows, 40, I] is written exactly once.  Each block's strip holds every
    sample its instants read, which lie within the history and hp2, and
    its shared memory fits a block (227 KB)."""
    rows, t = shape
    n = t // SUB
    plan = cuda_fir.fir_plan(taps)
    tiles, parts, blocks, strip_rows, smem = cuda_fir.launch_grid(
        rows, t, dtype, plan, 132)
    tile = cuda_fir.TILE_INSTANTS[dtype]
    assert blocks == rows * tiles * parts < 2 ** 31
    assert 1 <= parts <= cuda_fir.MAX_PARTS
    assert (tiles - 1) * tile < n <= tiles * tile
    if blocks <= 1 << 20:
        b = np.arange(blocks)
        keys = np.stack([b // parts // tiles, b // parts % tiles, b % parts])
        assert np.unique(keys, axis=1).shape[1] == blocks
        assert list(keys.max(1)) == [rows - 1, tiles - 1, parts - 1]
    full = tile_stores(dtype, 0, tile, plan, parts)
    assert np.all(store_counts(full, 0, tile) == 1)
    last = (tiles - 1) * tile
    stores = tile_stores(dtype, last, n, plan, parts)
    assert np.all(store_counts(stores, last, n - last) == 1)
    if tiles > 2:
        middle = (tiles // 2) * tile
        np.testing.assert_array_equal(
            tile_stores(dtype, middle, n, plan, parts), full + [0, middle])
    # the strip: from 32 i0 + jbase, strip_rows rows of 32
    assert plan.jbase <= plan.lo.min()
    assert SUB * strip_rows >= SUB * (tile - 1) + plan.hi.max() - plan.jbase
    assert smem <= 232448
    assert SUB * (n - 1) + plan.hi.max() <= cuda_fir.FIR_PAD + t


@pytest.mark.parametrize("dtype", DTYPES)
def test_small_grids_split_the_groups(taps, dtype):
    """The parts launch_grid picks on 132 SMs: none for the advanced
    batch, which fills the card many times over; more for one pair in
    float (30 tiles a row), each part's blocks all held at once."""
    plan = cuda_fir.fir_plan(taps)
    assert cuda_fir.launch_grid(128, 491520, dtype, plan, 132)[1] == 1
    tiles, parts, blocks, _, smem = cuda_fir.launch_grid(4, 480000, dtype,
                                                         plan, 132)
    held = 132 * (cuda_fir.SM_SHARED // (smem + cuda_fir.BLOCK_RESERVED))
    if dtype == torch.float32:
        assert tiles == 30 and parts > 1 and blocks <= held


@pytest.mark.parametrize("dtype", DTYPES)
def test_hour_offsets_are_64_bit(taps, dtype):
    """The one-hour one shot [4, 172,800,000]: the grid from the host, and
    the last block's offsets as the kernel forms them in 64 bits, exactly:
    the last output of each part is its 863,999,999th value, whose byte
    offset passes 2^31, as the last sample read does; in 32 bits both
    would wrap (as signed ints).  The kernel's source forms them in long
    long."""
    rows, t = HOUR
    plan = cuda_fir.fir_plan(taps)
    tiles, parts, blocks, _, _ = cuda_fir.launch_grid(rows, t, dtype, plan,
                                                      132)
    tile = cuda_fir.TILE_INSTANTS[dtype]
    n = t // SUB
    assert n == 5_400_000 and parts == 1
    assert tiles == -(-n // tile) and blocks == rows * tiles
    item = torch.empty((), dtype=dtype).element_size()
    block = np.int64(blocks - 1)
    row, i0 = block // parts // tiles, block // parts % tiles * tile
    out_row = row * BANDS
    last_store = tile_stores(dtype, int(i0), n, plan, parts)[:, 1].max()
    assert last_store == n - 1
    last_out = (out_row + BANDS - 1) * n + last_store
    assert last_out == rows * BANDS * n - 1 == 863_999_999
    last_in = row * t + (t - 1)
    assert last_in == rows * t - 1 == 691_199_999
    for offset in (last_out, last_in):
        assert offset * item > 2 ** 31
        assert (offset * item + 2 ** 31) % 2 ** 32 - 2 ** 31 != offset * item
    src = fir_source()
    for decl in ("const long long row = block / plan.parts / tiles;",
                 "const long long i0 = (block / plan.parts % tiles) * "
                 "kTileInstants<T>;",
                 "const long long out_row = row * kBands;",
                 "const long long i = i0 + kSub * warp + kMmaRows * m + g;",
                 "const long long i = i0 + threadIdx.x + kThreads * r;",
                 "const long long p = p0 + s;",
                 "stage(strip, x + row * t_len,"):
        assert decl in src, decl


def reenact(plan, dtype, x: np.ndarray, hist) -> np.ndarray:
    """F1 in numpy (float64): each block stages its strip as `stage` does
    (skewed, zeros past hp2's end) and sums each group's window as
    group_f64 (k-steps of 4 from one skewed base) or group_f32 does.
    Returns [rows, 80, I]."""
    rows, t = x.shape
    n = t // SUB
    tiles, _, _, strip_rows, _ = cuda_fir.launch_grid(rows, t, dtype, plan,
                                                      132)
    tile, skew = cuda_fir.TILE_INSTANTS[dtype], cuda_fir.SKEW[dtype]
    row_len = SUB + skew
    packed = (cuda_fir.packed_weight(plan, dtype, "cpu").numpy()
              if dtype == torch.float64 else plan.weights)
    xs = np.concatenate([np.zeros((rows, cuda_fir.FIR_PAD)) if hist is None
                         else hist[:, -cuda_fir.FIR_PAD:], x,
                         np.zeros((rows, SUB * (strip_rows + tile)))], 1)
    out = np.full((rows, 2 * BANDS, n), np.nan)
    s = np.arange(strip_rows * SUB)
    il = np.arange(tile)
    for b in range(rows * tiles):
        row, i0 = b // tiles, b % tiles * tile
        strip = np.zeros(strip_rows * row_len)
        strip[s + (s >> 5) * skew] = xs[row, SUB * i0 + plan.jbase + s]
        live = i0 + il < n
        for g in range(plan.groups):
            lo, hi = plan.lo[g], plan.hi[g]
            j = np.arange(lo, hi)
            if dtype == torch.float64:
                step = lo + (j - lo) // 4 * 4 - plan.jbase
                col = step + (step >> 5) * skew + (j - lo) % 4
                # B from its fragment: tap 4 s + l % 4 of channel l // 4
                frag = packed[plan.offset[g]:plan.offset[g] + 8 * (hi - lo)]
                lane = np.arange(32)
                w = np.zeros((hi - lo, 8))
                for s4 in range((hi - lo) // 4):
                    w[4 * s4 + lane % 4, lane // 4] = frag[32 * s4 + lane]
            else:
                col = (j - plan.jbase) + ((j - plan.jbase) >> 5) * skew
                w = packed[plan.offset[g]:plan.offset[g] + 8 * (hi - lo)]
            acc = strip[il[:, None] * row_len + col[None, :]] \
                @ w.reshape(-1, 8)
            for ch, c in enumerate(cuda_fir.group_channels(g)):
                out[row, c, i0 + il[live]] = acc[live, ch]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_history", [False, True])
def test_kernel_arithmetic_matches_plain(taps, dtype, with_history):
    """The kernel's indexing, re-enacted in float64 over the plan and the
    staged strip, against fir_bank_plain (1e-12 of max|plain|) on 3 rows
    of 700 instants (a tile and a ragged one in float, five and a ragged
    one in double), with and without a history of nonzeros."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, SUB * 700))
    hist = rng.standard_normal((3, FB.HIST_LEN)) if with_history else None
    plan = cuda_fir.fir_plan(taps)
    got = reenact(plan, dtype, x, hist)
    re, im = cuda_fir.fir_bank_plain(
        torch.from_numpy(x), torch.from_numpy(FB.fir_weight(taps)),
        None if hist is None else torch.from_numpy(hist))
    want = torch.cat([re, im], 1).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


def tt(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("with_history", [False, True])
def test_filter_bank_matches_jax_with_history(with_history):
    """FB.filter_bank (on the CPU: fir_bank_plain) against JAX
    filter_bank_t with the same history of nonzeros (or none), float64,
    within 1e-12 of max|JAX|, over a [2, 3] lead."""
    rng = np.random.default_rng(37)
    hp2 = rng.standard_normal((2, 3, 128 * 30))
    hist = (rng.standard_normal((2, 3, FB.HIST_LEN)) if with_history
            else None)
    want = JFB.filter_bank_t(
        JFB.build_consts(JEP.fb_ear_params()), jnp.asarray(hp2),
        history=None if hist is None else jnp.asarray(hist))
    got = FB.filter_bank(FB.build_consts(EP.fb_ear_params()), tt(hp2),
                         tt(hist))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 3, BANDS, 120)
        assert np.abs(g.numpy() - w).max() / np.abs(w).max() < 1e-12


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor runs fir_bank_plain and launches nothing; its outputs
    are contiguous, as the kernel's are."""
    monkeypatch.setattr(cuda_fir, "fir_bank_launches", 0)
    rng = np.random.default_rng(41)
    k = FB.build_consts(EP.fb_ear_params())
    hp2 = tt(rng.standard_normal((2, SUB * 50)))
    hist = tt(rng.standard_normal((2, FB.HIST_LEN)))
    for h in (None, hist):
        got = FB.filter_bank(k, hp2, h)
        want = cuda_fir.fir_bank_plain(hp2, k.fir_weight, h)
        for g, w in zip(got, want):
            assert torch.equal(g, w) and g.is_contiguous()
    assert cuda_fir.fir_bank_launches == 0


def test_other_devices_raise_without_fallback(taps):
    """A tensor on neither the CPU nor a CUDA card is refused before any
    build, as is a sample count off the 32-sample grid."""
    plan = cuda_fir.fir_plan(taps)
    weight = torch.ones(2 * BANDS, SUB, cuda_fir.FIR_BLOCKS, device="meta")
    hp2 = torch.ones(2, SUB * 4, device="meta")
    for hist in (None, torch.ones(2, FB.HIST_LEN, device="meta")):
        with pytest.raises(ValueError, match="CUDA"):
            cuda_fir.fir_bank(hp2, weight, plan, hist)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_fir.fir_bank(torch.ones(2, 33, device="meta"), weight, plan)
