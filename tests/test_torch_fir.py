"""The port's FIR bank (kernel F1, ops/cuda_fir.py and csrc/fir_bank.cu) on
the CPU.

F1 is not a TPU kernel: the JAX package leaves the bank to XLA
(gstpeaq_tpu/ops/fb_ear.py::filter_bank_t).  Here the host plan is held to
the conv weight it packs, bit for bit, and the weights as each dtype's
kernel reads them (float64: the k-major layout, taps outer and every
covering group of a pass inner; float32: group by group) to hold each
nonzero tap of each channel once, in ascending taps; its parts to balance
their covering work; the kernel's grid and store map, re-enacted from its
source's constants, to write each output once at every shape the port
gives it, up to the one-hour one shot with its 64-bit offsets; the
kernel's walk, re-enacted in numpy over its staged strip and packed
weights, to the plain version; and the plain version, with and without a
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
                        "kAlign", "kKAlign", "kChunk", "kOpen",
                        "kPerThread",
                        "kMmaRows", "kMTiles", "kMaxParts", "kMaxPasses",
                        "kMaxSegments", "kTapBits", "kCountShift",
                        "kCoverShift", "kEndShift")}
    for name in ("kThreads", "kTileInstants", "kSkew", "kMinBlocks"):
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
    assert cuda_fir.ALIGN == 4 and cuda_fir.K_ALIGN == 8
    assert np.all(plan.lo % cuda_fir.ALIGN == 0)
    assert np.all(plan.hi % cuda_fir.ALIGN == 0)
    assert plan.jbase % SUB == 0 and np.all(plan.lo >= plan.jbase)
    # the double layout's windows: the plan's rounded out to its k-step
    layout = cuda_fir.fir_layout(plan)
    np.testing.assert_array_equal(layout.lo, plan.lo // 8 * 8)
    np.testing.assert_array_equal(layout.hi, -(-plan.hi // 8) * 8)
    assert np.all(layout.lo >= plan.jbase)
    work = plan.hi - plan.lo
    assert len(plan.tables) == cuda_fir.MAX_PARTS
    for p in range(1, len(plan.tables) + 1):
        order, start = plan.parts(p)
        assert len(start) == p + 1
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
        assert 8 * (layout.hi - layout.lo).sum() == 48384


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
    layout = cuda_fir.fir_layout(plan)
    assert cuda_fir.fir_layout(plan) is layout
    for a in (layout.packed, *plan.tables, *layout.tables):
        with pytest.raises(ValueError):
            a[0] = 1
    double = cuda_fir.packed_weight(plan, torch.float64, "cpu")
    assert double.dtype == torch.float64
    np.testing.assert_array_equal(double.numpy(), layout.packed)
    assert double.numel() != packed.numel()
    for p in range(1, len(plan.tables) + 1):
        assert cuda_fir.kernel_table(plan, torch.float32, p) is \
            plan.tables[p - 1]
        assert cuda_fir.kernel_table(plan, torch.float64, p) is \
            layout.tables[p - 1]


def parse_group_table(table: np.ndarray, groups: int) -> dict:
    """The float kernel's table as read_table reads it (fir_bank.cu)."""
    out = {"lo": table[1:1 + groups], "hi": table[1 + groups:1 + 2 * groups],
           "offset": table[1 + 2 * groups:1 + 3 * groups]}
    t = table[1 + 3 * groups:]
    out["parts"] = int(t[0])
    out["order"] = t[1:1 + groups]
    out["part_start"] = t[1 + groups:]
    assert len(out["part_start"]) == out["parts"] + 1
    return out


def parse_table(table: np.ndarray, groups: int) -> dict:
    """The double kernel's table as read_table reads it (fir_bank.cu),
    each segment's first word split into its fields as `segment` does."""
    k = kernel_constants()
    t = table[1 + 2 * groups:]
    parts, passes, n_seg = (int(v) for v in t[:3])
    t = t[3:]
    out = {"lo": table[1:1 + groups], "hi": table[1 + groups:1 + 2 * groups],
           "parts": parts, "order": t[:groups]}
    t = t[groups:]
    out["pass_start"] = t[:passes + 1]
    t = t[passes + 1:]
    out["part_pass"], out["part_seg"] = t[:parts + 1], t[parts + 1:
                                                         2 * parts + 2]
    t = t[2 * parts + 2:]
    x, y = t[:n_seg], t[n_seg:]
    assert len(y) == n_seg
    taps_bits = k["kTapBits"]
    out["seg"] = [dict(j0=int(v) & ((1 << taps_bits) - 1),
                       taps=int(v) >> k["kCountShift"] & 0xFF,
                       cover=int(v) >> k["kCoverShift"] & 0xFF,
                       end=int(v) >> k["kEndShift"] & 1, weights=int(w))
                  for v, w in zip(x, y)]
    return out


def walk_groups(plan, p: int):
    """The float kernel's walk of the split into p parts, from its table:
    each part's groups in order, each over its window in chunks of CHUNK
    taps, a chunk's weights read at the group's offset from plan.weights
    (the float64 values packed_weight casts).  Yields (part, chunk's
    first tap j, group g, weights [taps, 8])."""
    t = parse_group_table(plan.tables[p - 1], plan.groups)
    assert t["parts"] == p
    packed = plan.weights
    for q in range(p):
        for g in t["order"][t["part_start"][q]:t["part_start"][q + 1]]:
            for j in range(t["lo"][g], t["hi"][g], cuda_fir.CHUNK):
                taps = min(cuda_fir.CHUNK, t["hi"][g] - j)
                at = t["offset"][g] + 8 * (j - t["lo"][g])
                yield q, int(j), int(g), packed[at:at + 8 * taps].reshape(
                    taps, 8)


def windows(plan, dtype) -> tuple[np.ndarray, np.ndarray]:
    """The groups' windows (lo, hi) the dtype's kernel walks: the plan's
    in float32, the double layout's (rounded out to K_ALIGN) in float64."""
    if dtype == torch.float32:
        return plan.lo, plan.hi
    layout = cuda_fir.fir_layout(plan)
    return layout.lo, layout.hi


def walk(plan, dtype, p: int):
    """The weights as the dtype's kernel reads them for the split into p
    parts: (part, first tap j, group g, weights [taps, 8])."""
    if dtype == torch.float32:
        yield from walk_groups(plan, p)
    else:
        for q, _, _, j, g, w in walk_layout(plan, p):
            yield q, j, g, w


def walk_layout(plan, p: int):
    """The double k-major layout of the split into p parts, read as the
    kernel reads it: each part's segments in order, the pass advancing
    after a segment that ends one, each k-step's record holding the
    fragments of the pass's first `cover` groups.  Yields (part, pass k,
    its groups, k-step's first tap j, group g, fragment [8 taps, 8] as
    the kernel's lanes read it)."""
    layout = cuda_fir.fir_layout(plan)
    t = parse_table(layout.tables[p - 1], plan.groups)
    assert t["parts"] == p
    step = cuda_fir.K_ALIGN
    frag = 8 * step
    lane = np.arange(32)
    for q in range(p):
        k = int(t["part_pass"][q])
        for i in range(t["part_seg"][q], t["part_seg"][q + 1]):
            sg = t["seg"][i]
            gs = t["order"][t["pass_start"][k]:t["pass_start"][k + 1]]
            for s, j in enumerate(range(sg["j0"], sg["j0"] + sg["taps"],
                                        step)):
                for c in range(sg["cover"]):
                    at = sg["weights"] + (s * sg["cover"] + c) * frag
                    v = layout.packed[at:at + frag]
                    w = np.zeros((step, 8))
                    for h in (0, 1):
                        w[4 * h + lane % 4, lane // 4] = v[32 * h + lane]
                    yield q, k, gs, j, int(gs[c]), w
            if sg["end"]:
                k += 1
        assert k == t["part_pass"][q + 1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["peaq", "random"])
def test_k_major_packing_holds_every_tap_once(taps, which, dtype):
    """Read as the dtype's kernel reads them (walk: float64's k-major
    layout, float32's group by group), each split's packed weights hold
    every tap of every group's window once, in ascending taps, with
    fb_ear.fir_weight's value bit for bit (zeros only where the conv
    weight is 0), and every packed weight is read: in float64 each
    split's run of the layout once, in float32 the group weights once a
    split."""
    if which == "random":
        taps = random_taps(np.random.default_rng(7))
    plan = cuda_fir.fir_plan(taps)
    want = FB.fir_weight(taps).transpose(0, 2, 1).reshape(2 * BANDS, -1)
    packed = cuda_fir.packed_weight(plan, dtype, "cpu")
    lo, hi = windows(plan, dtype)
    read = 0
    for p in range(1, len(plan.tables) + 1):
        got = np.zeros((2 * BANDS, SUB * cuda_fir.FIR_BLOCKS))
        seen = np.zeros(got.shape, np.int64)
        last = {}
        for _, j, g, w in walk(plan, dtype, p):
            assert last.get(g, -1) < j           # ascending taps
            last[g] = j
            ch = cuda_fir.group_channels(g)
            got[np.ix_(ch, range(j, j + len(w)))] = w.T
            seen[np.ix_(ch, range(j, j + len(w)))] += 1
            read += w.size
        for g in range(plan.groups):
            ch = cuda_fir.group_channels(g)
            assert np.all(seen[ch, lo[g]:hi[g]] == 1)
        assert seen.sum() == 8 * (hi - lo).sum()
        np.testing.assert_array_equal(got, want)
    splits = len(plan.tables) if dtype == torch.float32 else 1
    assert read == splits * packed.numel()


@pytest.mark.parametrize("dtype", DTYPES)
def test_parts_balance_the_covering_work(taps, dtype):
    """Each split into p parts: the parts' covering work (taps of their
    groups' windows) differ by at most the largest group's, none is empty,
    and the dtype's kernel table holds that split: in float64 each part's
    passes hold at most the kernel's OPEN groups, whose windows nest,
    widest first; in float32 each part's groups in band order.  For the
    FB ear's taps the largest part of 2, 3, 4 holds at most 61%, 41%, 30%
    of the work, where splitting the groups in band order would give 68%,
    54%, 45%."""
    plan = cuda_fir.fir_plan(taps)
    work = plan.hi - plan.lo
    shares = []
    for p in range(1, len(plan.tables) + 1):
        order, start = plan.parts(p)
        loads = [work[order[a:b]].sum() for a, b in zip(start, start[1:])]
        assert min(loads) > 0
        assert max(loads) - min(loads) <= work.max()
        shares.append(max(loads) / work.sum())
        table = cuda_fir.kernel_table(plan, dtype, p)
        if dtype == torch.float32:
            t = parse_group_table(table, plan.groups)
            assert t["parts"] == p
            np.testing.assert_array_equal(t["order"], order)
            np.testing.assert_array_equal(t["part_start"], start)
            for a, b in zip(start, start[1:]):
                assert list(order[a:b]) == sorted(order[a:b])
            continue
        layout = cuda_fir.fir_layout(plan)
        passes = layout.passes[p - 1]
        assert int(table[1 + 2 * plan.groups]) == p
        assert int(table[2 + 2 * plan.groups]) == len(passes)
        part_pass = parse_table(table, plan.groups)["part_pass"]
        for q, (a, b) in enumerate(zip(part_pass, part_pass[1:])):
            assert sorted(g for gs in passes[a:b] for g in gs) == sorted(
                order[start[q]:start[q + 1]])
        for gs in passes:
            assert 1 <= len(gs) <= cuda_fir.OPEN
            for g, h in zip(gs[1:], gs):          # nested, widest first
                assert layout.lo[h] <= layout.lo[g]
                assert layout.hi[g] <= layout.hi[h]
        assert sorted(g for gs in passes for g in gs) == list(
            range(plan.groups))
    assert shares[0] == 1.0
    np.testing.assert_array_less(shares[1:], [0.61, 0.41, 0.30])
    in_order = [max(work[a:b].sum() for a, b in zip(
        np.linspace(0, plan.groups, p + 1).astype(int)[:-1],
        np.linspace(0, plan.groups, p + 1).astype(int)[1:])) / work.sum()
        for p in (2, 3, 4)]
    np.testing.assert_array_less(shares[1:], in_order)


def group_plan_fits(t: dict) -> bool:
    """fir_bank.cu's float plan_fits, re-enacted on a parsed table:
    windows of whole k-steps from jbase, each group once, in parts that
    each hold a group; weights 32-byte aligned."""
    k = kernel_constants()
    lo, hi, order = t["lo"], t["hi"], t["order"]
    start = t["part_start"]
    return (1 <= t["parts"] <= min(k["kMaxParts"], len(order))
            and sorted(order) == list(range(len(order)))
            and all(lo % k["kAlign"] == 0) and all(hi % k["kAlign"] == 0)
            and all(hi >= lo) and all(t["offset"] % 8 == 0)
            and start[0] == 0 and start[-1] == len(order)
            and all(np.diff(start) > 0))


def plan_fits(t: dict) -> bool:
    """fir_bank.cu's double plan_fits, re-enacted on a parsed table:
    passes of at most kOpen groups whose windows nest, widest first; each
    pass's segments tiling its union from its first group's lo in
    ascending taps, at most kChunk taps each, of whole k-steps, covered by
    exactly the pass's first `cover` groups; weights 16-byte aligned."""
    k = kernel_constants()
    lo, hi, order = t["lo"], t["hi"], t["order"]
    step = k["kKAlign"]
    if len(t["seg"]) > k["kMaxSegments"] or \
            len(t["pass_start"]) - 1 > k["kMaxPasses"]:
        return False
    i = 0
    for q in range(t["parts"]):
        if i != t["part_seg"][q]:
            return False
        for kk in range(t["part_pass"][q], t["part_pass"][q + 1]):
            gs = order[t["pass_start"][kk]:t["pass_start"][kk + 1]]
            if not 1 <= len(gs) <= k["kOpen"]:
                return False
            if any(lo[g] < lo[h] or hi[g] > hi[h]
                   for g, h in zip(gs[1:], gs)):
                return False
            j = lo[gs[0]]
            while True:
                if i >= t["part_seg"][q + 1]:
                    return False
                sg = t["seg"][i]
                if (sg["j0"] != j or not 0 <= sg["taps"] <= k["kChunk"]
                        or sg["taps"] % step or sg["cover"] > len(gs)
                        or sg["weights"] % 8):
                    return False
                for c, g in enumerate(gs):
                    inside = lo[g] <= j and j + sg["taps"] <= hi[g]
                    outside = j + sg["taps"] <= lo[g] or hi[g] <= j
                    if sg["taps"] and not (inside if c < sg["cover"]
                                           else outside):
                        return False
                j += sg["taps"]
                if sg["end"]:
                    break
                i += 1
            if j != hi[gs[0]]:
                return False
            i += 1
    return i == len(t["seg"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["peaq", "random"])
def test_splits_pass_the_kernels_plan_check(taps, which, dtype):
    """Every split launch_grid may offer passes fir_bank.cu's plan check
    for the dtype (re-enacted in plan_fits and group_plan_fits), and a
    split it would refuse is not offered: the FB ear's plan fits at every
    count of parts; in float64 the random plan's four parts need more
    segments than the kernel holds, so a small grid takes fewer (float32
    holds any split)."""
    if which == "random":
        taps = random_taps(np.random.default_rng(0))
    plan = cuda_fir.fir_plan(taps)
    k = kernel_constants()
    offered = []
    for p in range(1, len(plan.tables) + 1):
        table = cuda_fir.kernel_table(plan, dtype, p)
        if dtype == torch.float32:
            fits = True
            assert group_plan_fits(parse_group_table(table, plan.groups))
        else:
            layout = cuda_fir.fir_layout(plan)
            fits = (len(layout.segments[p - 1]) <= k["kMaxSegments"]
                    and len(layout.passes[p - 1]) <= k["kMaxPasses"])
            assert plan_fits(parse_table(table, plan.groups)) == fits
        if fits:
            offered.append(p)
    parts = cuda_fir.launch_grid(1, SUB * 64, dtype, plan, 132)[1]
    assert parts in offered
    if which == "peaq" or dtype == torch.float32:
        assert offered == [1, 2, 3, 4]
    else:
        assert 4 not in offered and parts < 4


def test_double_weights_are_in_fragment_order(taps):
    """In float64 a group's fragment for a k-step of 8 taps is read as two
    mma B fragments: lane l of half h reads value 32 h + l of the record,
    which is tap 4 h + l % 4 of channel l // 4; in one part the groups
    go in band order, OPEN to a pass, and the first record is group 0's
    taps lo[0] .. lo[0] + 7."""
    plan = cuda_fir.fir_plan(taps)
    packed = cuda_fir.packed_weight(plan, torch.float64, "cpu").numpy()
    n = cuda_fir.OPEN
    assert cuda_fir.fir_layout(plan).passes[0] == tuple(
        tuple(range(a, min(a + n, plan.groups)))
        for a in range(0, plan.groups, n))
    assert cuda_fir.fir_layout(plan).lo[0] == plan.lo[0]
    rows = plan.group_weights(0)[:8]                  # [8 taps, 8]
    lane = np.arange(32)
    for h in (0, 1):
        np.testing.assert_array_equal(packed[32 * h + lane],
                                      rows[4 * h + lane % 4, lane // 4])


def test_plan_constants_are_the_kernels():
    """The wrapper's copies of fir_bank.cu's constants, and the kernel's C
    entries in _build.SIGNATURES."""
    k = kernel_constants()
    assert k["kSub"] == SUB and k["kFirPad"] == cuda_fir.FIR_PAD
    assert k["kBands"] == BANDS and k["kGroupBands"] == cuda_fir.GROUP_BANDS
    assert k["kAlign"] == cuda_fir.ALIGN
    assert k["kKAlign"] == cuda_fir.K_ALIGN
    assert k["kTileInstants"] == cuda_fir.TILE_INSTANTS
    assert k["kOpen"] == cuda_fir.OPEN
    assert k["kSkew"] == cuda_fir.SKEW
    assert k["kChunk"] == cuda_fir.CHUNK
    assert k["kMaxParts"] == cuda_fir.MAX_PARTS
    assert k["kMaxPasses"] == cuda_fir.MAX_PASSES
    assert k["kMaxSegments"] == cuda_fir.MAX_SEGMENTS
    assert ("constexpr int kWeightValues = kChunk * kGroupChannels * "
            "(sizeof(T) == 4 ? 1 : kOpen);") in " ".join(fir_source().split())
    # the blocks an SM holds, as the wrapper's grid counts them, are those
    # the kernel's registers are bounded for
    plan = cuda_fir.fir_plan(FB.folded_taps(EP.fb_ear_params()))
    for dtype in DTYPES:
        smem = cuda_fir.launch_grid(1, SUB, dtype, plan, 1)[-1]
        held = cuda_fir.SM_SHARED // (smem + cuda_fir.BLOCK_RESERVED)
        assert held == k["kMinBlocks"][dtype]
    # every split's passes and segments fit the double kernel's plan
    layout = cuda_fir.fir_layout(plan)
    for passes, segments in zip(layout.passes, layout.segments):
        assert len(passes) <= cuda_fir.MAX_PASSES
        assert len(segments) <= cuda_fir.MAX_SEGMENTS
    for suffix in ("f32", "f64"):
        assert len(_build.SIGNATURES[f"peaq_fir_bank_{suffix}"]) == 12
    assert len(_build.SIGNATURES["peaq_fir_mma_rate"]) == 5
    assert set(cuda_fir.MMA_SHAPES) == {0, 1, 2, 3}


def block_stores(dtype, i0: int, n_inst: int, groups) -> np.ndarray:
    """One block's stores (fir_bank.cu's store_pass / store_group
    re-enacted) of `groups` (its passes' or its part's groups, in order) at
    tile start
    i0 of a row of n_inst instants: [stores, 2] of (channel, part x 40 +
    band, and instant), the masked ones dropped."""
    k = kernel_constants()
    gb = k["kGroupBands"]
    tid = np.arange(k["kThreads"][dtype])
    stores = []
    for grp in groups:
        if dtype == torch.float64:
            warp, lane = tid >> 5, tid & 31
            pairs = [(2 * (lane & 3) + (e & 1),
                      i0 + k["kMmaRows"] * (k["kMTiles"] * warp + m)
                      + (lane >> 2) + 8 * (e >> 1))
                     for m in range(k["kMTiles"]) for e in range(4)]
        else:
            pairs = [(np.full_like(tid, ch),
                      i0 + tid + k["kThreads"][dtype] * r)
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
    """The stores of a tile's blocks, one per part of the groups, each
    storing its groups as each ends: in float64 its passes' groups as each
    pass ends, in float32 each group of its part as its window ends."""
    if dtype == torch.float32:
        t = parse_group_table(plan.tables[parts - 1], plan.groups)
        start = t["part_start"]
        return np.concatenate([
            block_stores(dtype, i0, n_inst, t["order"][a:b])
            for a, b in zip(start, start[1:])])
    layout = cuda_fir.fir_layout(plan)
    passes = layout.passes[parts - 1]
    part_pass = parse_table(layout.tables[parts - 1],
                            plan.groups)["part_pass"]
    return np.concatenate([
        block_stores(dtype, i0, n_inst,
                     [g for gs in passes[a:b] for g in gs])
        for a, b in zip(part_pass, part_pass[1:])])


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
    lo, hi = windows(plan, dtype)
    assert plan.jbase <= lo.min()
    assert SUB * strip_rows >= SUB * (tile - 1) + hi.max() - plan.jbase
    assert smem <= 232448
    assert SUB * (n - 1) + hi.max() <= cuda_fir.FIR_PAD + t


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
    src = " ".join(fir_source().split())
    for decl in ("const long long row = block / plan.parts / tiles;",
                 "const long long i0 = (block / plan.parts % tiles) * "
                 "kTileInstants<T>;",
                 "const long long out_row = row * kBands;",
                 "(out_row + kGroupBands * grp + (ch % kGroupBands)) * "
                 "n_inst;",
                 "long long out_row, long long n_inst) {",
                 "const long long i = i0 + kMmaRows * (kMTiles * warp + m) "
                 "+ (lane >> 2) + 8 * (e >> 1);",
                 "const long long i = i0 + threadIdx.x + kThreads<float> * "
                 "r;",
                 "const long long p = p0 + s;",
                 "const T* x_row = x + row * t_len;",
                 "const long long p0 = kSub * i0 + plan.jbase;",
                 "stage(strip, x_row, h_row, t_len, p0, plan.strip_rows);"):
        assert decl in src, decl


def reenact(plan, dtype, x: np.ndarray, hist, parts: int) -> np.ndarray:
    """F1 in numpy (float64) with its groups split into `parts` parts:
    each block stages its strip as `stage` does (skewed, zeros past hp2's
    end), and walks its weights as the dtype's kernel does (walk): in
    float64 taps outer, each k-step's strip values read once and their
    product with each covering group's fragment, the next in the step's
    record of the packed weights, added to that group's sums; in float32
    group by group, chunk by chunk.  All blocks of a part at once.
    Returns [rows, 80, I]."""
    rows, t = x.shape
    n = t // SUB
    tiles, _, _, strip_rows, _ = cuda_fir.launch_grid(rows, t, dtype, plan,
                                                      132)
    tile, skew = cuda_fir.TILE_INSTANTS[dtype], cuda_fir.SKEW[dtype]
    row_len = SUB + skew
    xs = np.concatenate([np.zeros((rows, cuda_fir.FIR_PAD)) if hist is None
                         else hist[:, -cuda_fir.FIR_PAD:], x,
                         np.zeros((rows, SUB * (strip_rows + tile)))], 1)
    s = np.arange(strip_rows * SUB)
    blocks = np.arange(rows * tiles)
    row, i0 = blocks // tiles, blocks % tiles * tile
    strips = np.zeros((len(blocks), strip_rows * row_len))
    strips[:, s + (s >> 5) * skew] = xs[row[:, None],
                                        SUB * i0[:, None] + plan.jbase + s]
    il = np.arange(tile)
    acc = {}
    for _, j, g, w in walk(plan, dtype, parts):
        col = j - plan.jbase + np.arange(len(w))
        a = strips[:, il[:, None] * row_len + (col + (col >> 5) * skew)]
        acc[g] = acc.get(g, 0.0) + a @ w                # [blocks, tile, 8]
    out = np.full((rows, 2 * BANDS, n + tile), np.nan)
    at = i0[:, None] + il                               # [blocks, tile]
    for g, v in acc.items():
        for ch, c in enumerate(cuda_fir.group_channels(g)):
            out[row[:, None], c, at] = v[..., ch]
    return out[..., :n]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_history", [False, True])
def test_kernel_arithmetic_matches_plain(taps, dtype, with_history):
    """The kernel's walk, re-enacted in float64 over the dtype's packed
    weights and the staged strip (reenact), against fir_bank_plain
    (1e-12 of max|plain|) on 3 rows of 700 instants (a tile and a ragged
    one in float, five and a ragged one in double), with and without a
    history of nonzeros, at every split of the groups into parts."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, SUB * 700))
    hist = rng.standard_normal((3, FB.HIST_LEN)) if with_history else None
    plan = cuda_fir.fir_plan(taps)
    re, im = cuda_fir.fir_bank_plain(
        torch.from_numpy(x), torch.from_numpy(FB.fir_weight(taps)),
        None if hist is None else torch.from_numpy(hist))
    want = torch.cat([re, im], 1).numpy()
    for parts in range(1, len(plan.tables) + 1):
        got = reenact(plan, dtype, x, hist, parts)
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
