"""Chunked streaming PEAQ for long programs, with the state carried on the
device (gstpeaq_tpu/parallel/stream.py).

The reference is streaming by nature: GStreamer pushes buffers and every
model state lives in per-component structs (src/gstpeaq.c:596-661).  Here
the state is an explicit tree of tensors on the device, carried between
fixed-size chunk steps: O(1) memory in the program's length, saved and
restored with utils/checkpoint.py in the JAX package's layout (so either
package resumes the other's checkpoint), and the ODG readable at any
prefix, like the element's live `odg` property (src/gstpeaq.c:475-503).

The accumulators keep the reference's INIT / tentative semantics
(src/movaccum.c:304-354, models/accum.py in one shot) with three carried
aggregates per MOV:
    all       sums over every accumulated frame so far
    committed sums as of the latest above-threshold frame
    has_above whether any above-threshold frame has occurred
and a reading takes `committed` (equal to `all` while the stream is in an
above-threshold stretch), which reproduces the reference's snapshot.

Each chunk step is written once over a leading stream axis: signals
[N, CH, T], band domain [2(ref, test), N, CH, Z, F], every state leaf
[N, ...].  PeaqStreamPool runs it at N streams; PeaqStream and
PeaqStreamAdvanced at N = 1, with their `state` in the JAX package's
scalar layout (no leading axis).  The hand kernels take raw pointers, so
torch.func.vmap cannot carry them: every reduction of the JAX package's
scalar step is a per-stream reduction here.  The steps run the level
adapter and the modulation processor unfused (kernel K1 with y0, never
K2, whose kernel takes no state), as the JAX streams do.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import api
from .. import constants as C
from ..models import level_adapt as LA
from ..models import movs as MOVS
from ..models import nn as NN
from ..models.basic import energy_totals
from ..models.modulation import modulation
from ..ops import cuda_band
from ..ops import cuda_ehs
from ..ops import cuda_gate
from ..ops import exact
from ..ops import fb_ear as FB
from ..ops import fft_ear as FE
from ..ops import framing
from ..ops import iir
from ..utils.checkpoint import tree_flatten, tree_map, tree_unflatten
from .batch import as_2d_ship, batch_pipeline

# Checkpoint compatibility tag (utils/checkpoint.py embeds and checks it),
# the JAX package's: bump it whenever the carried state changes shape or
# meaning.
#   2: complex biquad carries became real [..., 2] pairs; FB e0 tail
#      [CH, 10, Z] -> [CH, Z, 10]
#   3: FB conv history 1455 -> 1536 samples
STATE_FORMAT_VERSION = 3

INT32_MAX = int(np.iinfo(np.int32).max)
SUM_KEYS = ("all", "committed", "all_den", "committed_den")


def _dequant_host(x: np.ndarray) -> np.ndarray:
    """Host-side twin of framing.dequantize: int16 PCM -> float32."""
    return (x.astype(np.float32) / 32768.0) if x.dtype == np.int16 else x


def _cat_ship(buf: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Append to a stream buffer along the sample axis (-2).  An EMPTY
    buffer adopts the incoming dtype, so that int16 PCM ships raw and is
    dequantized on the device (framing.dequantize), half the bytes of
    float32.  Feeds of mixed dtypes fall back to float32 with the int16
    side dequantized on the host (upcasting the raw values would be 32768x
    too loud); keep a stream's feeds one dtype."""
    if buf.dtype != new.dtype:
        if buf.shape[-2] == 0:
            buf = buf.astype(new.dtype)
        else:
            buf, new = _dequant_host(buf), _dequant_host(new)
    return np.concatenate([buf, new], axis=-2)


# ---------------------------------------------------------------------------
# States, in the JAX package's scalar layout
# ---------------------------------------------------------------------------


def _maker(pipe):
    """(zeros(*shape) in the band dtype on the pipeline's device, device)."""
    dtype, device = pipe.avg_matrix.dtype, pipe.avg_matrix.device
    return (lambda *s: torch.zeros(s, dtype=dtype, device=device)), device


def _flags(device, **names):
    """The scalar bookkeeping leaves: bools False, int32 counters 0, lrf
    at int32's max."""
    out = {}
    for name, kind in names.items():
        if kind == "bool":
            out[name] = torch.zeros((), dtype=torch.bool, device=device)
        else:
            out[name] = torch.full((), INT32_MAX if name == "lrf" else 0,
                                   dtype=torch.int32, device=device)
    return out


def init_basic_state(pipe, channels: int) -> dict:
    """A fresh basic stream's state (gstpeaq_tpu/parallel/stream.py:90-116),
    every float leaf zero in the band dtype, on the pipeline's device."""
    f, device = _maker(pipe)
    z = pipe.consts.band_count
    sums = {name: {key: f(channels) for key in SUM_KEYS}
            for name in C.MOV_BASIC_NAMES}
    for name in ("ADBB", "MFPDB"):      # binaural: one value per stream
        sums[name] = {key: f(1) for key in SUM_KEYS}
    return {
        "smear": f(2, channels, z),
        "la": tuple(f(channels, z) for _ in range(6)),
        "mod": tuple((f(channels, z),) * 3 for _ in range(2)),
        "sums": sums,
        "mfpd_filt": f(1),
        "mfpd_max_all": f(1),
        "mfpd_max_committed": f(1),
        "win_sqrts": f(channels, 3),
        "signal_energy": f(),
        "noise_energy": f(),
        **_flags(device, win_calls="int32", has_above="bool",
                 frame_offset="int32", lrf="int32"),
    }


def init_advanced_state(pipe, channels: int) -> dict:
    """A fresh advanced stream's state (gstpeaq_tpu/parallel/stream.py:
    346-380): the FFT path's smear and the FB path's ear states (the
    fb_ear.process_signal tuple) per signal, as the basic one otherwise."""
    f, device = _maker(pipe)
    zf, zb = pipe.fft.band_count, C.FB_BAND_COUNT
    sums = {name: {key: f(channels) for key in SUM_KEYS}
            for name in C.MOV_ADVANCED_NAMES}
    sums["RmsNoiseLoudAsymA"]["all2"] = f(channels)
    sums["RmsNoiseLoudAsymA"]["committed2"] = f(channels)

    def fb_model_state():
        dc = tuple(f(channels, 2) for _ in range(4))
        return (dc, f(channels, FB.HIST_LEN), f(channels, zb),
                (f(channels, zb, FB.E0_TAIL), f(channels, zb)))

    return {
        "sums": sums,
        "smear": f(2, channels, zf),
        "fb_ref": fb_model_state(),
        "fb_test": fb_model_state(),
        "la": tuple(f(channels, zb) for _ in range(6)),
        "mod": tuple((f(channels, zb),) * 3 for _ in range(2)),
        "signal_energy": f(),
        "noise_energy": f(),
        **_flags(device, has_above_fft="bool", has_above_fb="bool",
                 frame_offset_fb="int32", lrf="int32"),
    }


# ---------------------------------------------------------------------------
# Chunk steps over a leading stream axis
# ---------------------------------------------------------------------------


class _Activity:
    """The accumulators' activity in one chunk, per stream, from the
    carried has_above [N] and this chunk's threshold gate above [N, F]:
    `active` [N, F] (an accumulator has left INIT), `any_above` [N] and
    `upto` [N, F] (frames up to the chunk's last above-threshold frame,
    whose sums become visible)."""

    def __init__(self, has_above: torch.Tensor, above: torch.Tensor):
        f = above.shape[-1]
        ints = above.to(torch.int32)          # argmax takes no bool tensor
        self.active = has_above[:, None] | (torch.cumsum(ints, -1) > 0)
        self.any_above = torch.any(above, dim=-1)
        self.t_last = f - 1 - torch.argmax(torch.flip(ints, (-1,)), dim=-1)
        self.upto = (torch.arange(f, device=above.device)
                     <= self.t_last[:, None])
        self.has_above = has_above | self.any_above

    def at_last(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, ..., F] at each stream's t_last: [N, ...]."""
        idx = self.t_last.view(-1, *[1] * (x.dim() - 1))
        return torch.gather(x, -1, idx.expand(*x.shape[:-1], 1))[..., 0]

    def update(self, entry: dict, num, den, gate, num2=None) -> dict:
        """One MOV's aggregates after this chunk.  num/den (and num2, the
        second input of MODE_RMS_ASYM): [N, CH or 1, F]; gate: [N, F] or
        [F], the MOV's own frame gate."""
        mask = (self.active & gate)[:, None, :]
        any_above = self.any_above[:, None]

        def sums(x, key):
            x = torch.where(mask, x, 0.0)
            every = entry["all" + key] + torch.sum(x, dim=-1)
            upto = entry["all" + key] + torch.sum(
                torch.where(self.upto[:, None, :], x, 0.0), dim=-1)
            return every, torch.where(any_above, upto,
                                      entry["committed" + key])

        out = {}
        out["all"], out["committed"] = sums(num, "")
        out["all_den"], out["committed_den"] = sums(den, "_den")
        if num2 is not None:
            out["all2"], out["committed2"] = sums(num2, "2")
        return out


def _first_loud(loud2: torch.Tensor, f_glob: torch.Tensor,
                lrf: torch.Tensor) -> torch.Tensor:
    """The first frame with the loudness reached in both signals of some
    channel, carried per stream: loud2 [2, N, CH, F] of (ref, test), f_glob
    [N, F] the frames' indices in the program; lrf [N] int32."""
    loud_ok = torch.any((loud2[0] > 0.1) & (loud2[1] > 0.1), dim=-2)
    first = torch.argmax(loud_ok.to(torch.int32), dim=-1, keepdim=True)
    found = torch.where(torch.any(loud_ok, dim=-1),
                        torch.gather(f_glob, -1, first)[:, 0], INT32_MAX)
    return torch.minimum(lrf, found.to(torch.int32))


def _stacked(pair):
    """Two trees of one structure -> one tree of stacked leaves [2, ...]."""
    return tree_unflatten(pair[0], [
        torch.stack([a, b]) for a, b in zip(tree_flatten(pair[0]),
                                            tree_flatten(pair[1]))])


def _split(tree):
    """A tree of stacked leaves [2, ...] -> its two trees, each leaf a copy
    that owns its storage."""
    return tuple(tree_map(lambda x, i=i: x[i].clone(), tree)
                 for i in range(2))


def _modulation_pair(a, uns2, step_size: int, state):
    """The modulation processor of both signals in one K1 call: uns2
    [2, N, CH, Z, F]; state: ((prev, fd, fl) of ref, of test), each
    [N, CH, Z].  Returns (mod2, avg_loud2, new state)."""
    mod2, loud2, new = modulation(a, uns2, step_size, _stacked(state))
    return mod2, loud2, _split(new)


def _frames(state_offset: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Each stream's frame indices in the program, [N, F]."""
    return state_offset[:, None] + torch.arange(
        n_frames, device=state_offset.device)


def _energy(state: dict, halves) -> dict:
    signal, noise = energy_totals(halves, None)
    return {"signal_energy": state["signal_energy"] + signal,
            "noise_energy": state["noise_energy"] + noise}


def _fft_front(k, ref_sig, test_sig, bandwidth: bool):
    """The threshold gate [N, F] and the stateless ear model
    (fft_ear.stateless_pair_movs, both signals spread, the bandwidth where
    asked) of an FFT-path chunk [N, CH, (F + 1) * 1024]."""
    n_frames = ref_sig.shape[-1] // C.FFT_STEPSIZE - 1
    above = cuda_gate.frame_gate(ref_sig, n_frames, C.FFT_FRAMESIZE,
                                 C.FFT_STEPSIZE, k.hann.dtype)
    return above, FE.stateless_pair_movs(
        k, framing.blocks_hop(ref_sig, n_frames),
        framing.blocks_hop(test_sig, n_frames), bandwidth=bandwidth)


def basic_chunk_step(pipe, state: dict, ref_sig: torch.Tensor,
                     test_sig: torch.Tensor) -> dict:
    """One chunk of the basic version (gstpeaq_tpu/parallel/stream.py:
    118-279).  pipe: a models.basic.BasicPipeline (its constants and
    settings); state: leaves [N, ...]; ref/test_sig: [N, CH, (F + 1) * 1024]
    float, or int16 PCM dequantized here.  Returns the new state."""
    k, settings = pipe.consts, pipe.settings
    dtype = k.internal_noise.dtype
    ref_sig = framing.dequantize(ref_sig)
    test_sig = framing.dequantize(test_sig)
    above, ear = _fft_front(k, ref_sig, test_sig, bandwidth=True)
    n_frames = above.shape[-1]
    uns_t = ear.unsmeared.transpose(-1, -2).contiguous()  # [2, N, CH, Z, F]
    exc, smear = FE.time_smear(k, uns_t, axis=-1,
                               state=state["smear"].movedim(1, 0),
                               return_state=True)
    lev_corr, pc, la = LA.level_adapt_factors(k.adapt_a, pipe.avg_matrix,
                                              exc, state["la"])
    mod2, avg_loud2, mod = _modulation_pair(k.adapt_a, uns_t,
                                            C.FFT_STEPSIZE, state["mod"])

    # per-frame MOV terms (M1), [N, CH, F] ([N, F] binaural)
    band = cuda_band.band_movs(
        k, "basic", exc, lev_corr, pc, mod2, avg_loud2[0],
        ear.noise_in_bands,
        use_floor=settings.use_floor_for_steps_above_threshold)
    f_glob = _frames(state["frame_offset"], n_frames)
    lrf = _first_loud(band.loudness, f_glob, state["lrf"])
    md_gate = f_glob >= 24
    nl_gate = md_gate & (f_glob - 3 >= lrf[:, None])

    md1, md2, temp_wt, nl = band.terms
    bw_ref, bw_test, bw_valid = ear.bandwidth
    nmr_mean, disturbed = band.nmr
    p_bin, steps_bin = band.detect
    ehs_val = cuda_ehs.ehs_frames(ear.ehs_difference, pipe.ehs_window,
                                  settings.ehs_subtract_dc_before_window)
    ehs_valid = MOVS.ehs_valid(ear.threshold[0], ear.threshold[1])

    # ---- streaming accumulation ----
    act = _Activity(state["has_above"], above)
    every = torch.ones_like(above)
    one = torch.ones_like(md1)
    sums = dict(state["sums"])
    upd = act.update
    sums["BandwidthRefB"] = upd(sums["BandwidthRefB"], bw_ref * bw_valid,
                                bw_valid.to(dtype), every)
    sums["BandwidthTestB"] = upd(sums["BandwidthTestB"], bw_test * bw_valid,
                                 bw_valid.to(dtype), every)
    sums["TotalNMRB"] = upd(sums["TotalNMRB"], nmr_mean, one, every)
    sums["AvgModDiff1B"] = upd(sums["AvgModDiff1B"], md1 * temp_wt, temp_wt,
                               md_gate)
    sums["AvgModDiff2B"] = upd(sums["AvgModDiff2B"], md2 * temp_wt, temp_wt,
                               md_gate)
    sums["RmsNoiseLoudB"] = upd(sums["RmsNoiseLoudB"], nl * nl, one, nl_gate)
    sums["RelDistFramesB"] = upd(sums["RelDistFramesB"], disturbed, one,
                                 every)
    valid = ehs_valid[:, None, :]
    sums["EHSB"] = upd(sums["EHSB"], torch.where(valid, ehs_val, 0.0),
                       valid.to(dtype) * one, every)
    steps = steps_bin[:, None, :]
    sums["ADBB"] = upd(sums["ADBB"], steps, torch.ones_like(steps),
                       p_bin > 0.5)

    # MFPD: the 0.9/0.1 filter on the frames accumulate() is called on
    # (every non-INIT frame), its running max, and the max's snapshot
    called = act.active[:, None, :]
    filt = iir.linear_recurrence(
        torch.where(called, p_bin.new_tensor(0.9), p_bin.new_tensor(1.0)),
        torch.where(called, 0.1 * p_bin[:, None, :], 0.0), axis=-1,
        y0=state["mfpd_filt"].to(p_bin.dtype))
    runmax = torch.maximum(
        torch.cummax(torch.where(called, filt, -math.inf), dim=-1).values,
        state["mfpd_max_all"][..., None])
    mfpd_committed = torch.where(act.any_above[:, None], act.at_last(runmax),
                                 state["mfpd_max_committed"])

    # WinModDiff: the sliding 4-window over the called frames (contiguous)
    win_called = act.active & md_gate
    sq = exact.sqrt(torch.where(win_called[:, None, :], md1, 0.0))
    ext = torch.cat([state["win_sqrts"].to(sq.dtype), sq], dim=-1)
    wsum = (ext[..., 3:] + ext[..., 2:-1] + ext[..., 1:-2]
            + ext[..., :-3]) / 4.0
    calls = torch.cumsum(win_called.to(torch.int32), dim=-1)
    call_idx = state["win_calls"][:, None] + calls - 1
    sums["WinModDiff1B"] = upd(sums["WinModDiff1B"], wsum ** 4, one,
                               win_called & (call_idx >= 3))

    return {
        "smear": smear.movedim(0, 1),
        "la": la,
        "mod": mod,
        "sums": sums,
        "mfpd_filt": filt[..., -1].clone(),
        "mfpd_max_all": runmax[..., -1].clone(),
        "mfpd_max_committed": mfpd_committed,
        "win_sqrts": ext[..., -3:].clone(),
        # int32 + the int64 count, as the JAX step's int32 + jnp.sum with
        # 64-bit types on (its float64 tier)
        "win_calls": state["win_calls"] + calls[:, -1],
        "has_above": act.has_above,
        "frame_offset": state["frame_offset"] + n_frames,
        "lrf": lrf,
        **_energy(state, ear.halves),
    }


def fft_chunk_step(pipe, state: dict, ref_sig: torch.Tensor,
                   test_sig: torch.Tensor) -> dict:
    """One FFT-path chunk of the advanced version (SegmentalNMRB, EHSB;
    gstpeaq_tpu/parallel/stream.py:407-462).  pipe: a models.advanced.
    AdvancedPipeline; ref/test_sig: [N, CH, (F + 1) * 1024].  Both signals
    are spread and smeared, since the state carries both smears (the
    checkpoint layout), though only the reference's excitation is read."""
    kf, settings = pipe.fft, pipe.settings
    dtype = kf.internal_noise.dtype
    ref_sig = framing.dequantize(ref_sig)
    test_sig = framing.dequantize(test_sig)
    above, ear = _fft_front(kf, ref_sig, test_sig, bandwidth=False)
    exc, smear = FE.time_smear(kf,
                               ear.unsmeared.transpose(-1, -2).contiguous(),
                               axis=-1, state=state["smear"].movedim(1, 0),
                               return_state=True)
    nmr_mean = cuda_band.band_movs(kf, "fft", exc[0],
                                   noise=ear.noise_in_bands).nmr[0]
    ehs_val = cuda_ehs.ehs_frames(ear.ehs_difference, pipe.ehs_window,
                                  settings.ehs_subtract_dc_before_window)
    ehs_valid = MOVS.ehs_valid(ear.threshold[0], ear.threshold[1])
    act = _Activity(state["has_above_fft"], above)
    every = torch.ones_like(above)
    one = torch.ones_like(nmr_mean)
    sums = dict(state["sums"])
    sums["SegmentalNMRB"] = act.update(
        sums["SegmentalNMRB"], 10.0 * exact.log10(nmr_mean), one, every)
    valid = ehs_valid[:, None, :]
    sums["EHSB"] = act.update(sums["EHSB"], torch.where(valid, ehs_val, 0.0),
                              valid.to(dtype) * one, every)
    new_state = dict(state)
    new_state.update(sums=sums, smear=smear.movedim(0, 1),
                     has_above_fft=act.has_above,
                     **_energy(state, ear.halves))
    return new_state


def fb_chunk_step(pipe, state: dict, ref_sig: torch.Tensor,
                  test_sig: torch.Tensor) -> dict:
    """One FB-path chunk of the advanced version (RmsModDiffA,
    RmsNoiseLoudAsymA, AvgLinDistA; gstpeaq_tpu/parallel/stream.py:
    464-543).  ref/test_sig: [N, CH, 192 F].  Both signals run through the
    FB ear in one call (each kernel launched once), with their states
    stacked."""
    kb, settings = pipe.fb, pipe.settings
    sdtype = kb.level_factor.dtype
    sig = framing.dequantize(torch.stack([ref_sig, test_sig]))
    n_fb = sig.shape[-1] // C.FB_FRAMESIZE
    above = cuda_gate.frame_gate(sig[0], n_fb, C.FB_FRAMESIZE,
                                 C.FB_FRAMESIZE, sdtype)
    sig = sig.to(sdtype)
    exc2, uns2, fb_new = FB.process_signal(
        kb, sig, n_fb, _stacked((state["fb_ref"], state["fb_test"])), True)
    lev_corr, pc, la = LA.level_adapt_factors(kb.adapt_a, pipe.avg_matrix,
                                              exc2, state["la"])
    mod2, avg_loud2, mod = _modulation_pair(kb.adapt_a, uns2,
                                            C.FB_FRAMESIZE, state["mod"])
    band = cuda_band.band_movs(
        kb, "fb", exc2, lev_corr, pc, mod2, avg_loud2[0],
        swap=settings.swap_mod_patts_for_noise_loudness_movs)

    f_glob = _frames(state["frame_offset_fb"], n_fb)
    lrf = _first_loud(band.loudness, f_glob, state["lrf"])
    md_gate = f_glob >= 125
    nl_gate = md_gate & (f_glob - 13 >= lrf[:, None])

    md1, _, temp_wt, nl_asym, missing, lin_dist = band.terms

    act = _Activity(state["has_above_fb"], above)
    one = torch.ones_like(md1)
    sums = dict(state["sums"])
    # MODE_RMS accumulates w^2 v^2 / w^2; src/movaccum.c:375-378
    sums["RmsModDiffA"] = act.update(
        sums["RmsModDiffA"], temp_wt * temp_wt * md1 * md1,
        temp_wt * temp_wt, md_gate)
    sums["RmsNoiseLoudAsymA"] = act.update(
        sums["RmsNoiseLoudAsymA"], nl_asym * nl_asym, one, nl_gate,
        num2=missing * missing)
    sums["AvgLinDistA"] = act.update(sums["AvgLinDistA"], lin_dist, one,
                                     nl_gate)
    fb_ref, fb_test = _split(fb_new)
    new_state = dict(state)
    new_state.update(
        sums=sums, fb_ref=fb_ref, fb_test=fb_test, la=la, mod=mod,
        has_above_fb=act.has_above,
        frame_offset_fb=state["frame_offset_fb"] + n_fb, lrf=lrf)
    return new_state


def read_movs(pipe, state: dict, advanced: bool):
    """MOVs [N, M], DI [N] and ODG [N] of a state (any prefix), in the
    cognitive network's dtype."""
    sums = state["sums"]
    dtype = pipe.cognitive.wx.dtype

    def frac(name, key="committed"):
        return (sums[name][key] / sums[name]["committed_den"]).to(dtype)

    def mean(x):
        return torch.mean(x, dim=-1)        # over each stream's channels

    if advanced:
        vals = {"SegmentalNMRB": mean(frac("SegmentalNMRB")),
                "EHSB": mean(frac("EHSB")),
                "RmsModDiffA": mean(exact.sqrt(frac("RmsModDiffA"))),
                "AvgLinDistA": mean(frac("AvgLinDistA")),
                "RmsNoiseLoudAsymA": mean(
                    exact.sqrt(frac("RmsNoiseLoudAsymA"))
                    + 0.5 * exact.sqrt(frac("RmsNoiseLoudAsymA",
                                            "committed2")))}
        names = C.MOV_ADVANCED_NAMES
    else:
        vals = {name: mean(frac(name)) for name in (
            "BandwidthRefB", "BandwidthTestB", "AvgModDiff1B",
            "AvgModDiff2B", "RelDistFramesB", "EHSB")}
        vals["TotalNMRB"] = mean(10.0 * exact.log10(frac("TotalNMRB")))
        for name in ("RmsNoiseLoudB", "WinModDiff1B"):
            vals[name] = mean(exact.sqrt(frac(name)))
        num = sums["ADBB"]["committed"][:, 0].to(dtype)
        den = sums["ADBB"]["committed_den"][:, 0].to(dtype)
        vals["ADBB"] = torch.where(
            den > 0, torch.where(num == 0.0, -0.5, exact.log10(
                torch.clamp_min(num, 1e-300) / den)), 0.0)
        vals["MFPDB"] = torch.clamp_min(
            state["mfpd_max_committed"][:, 0], 0.0).to(dtype)
        names = C.MOV_BASIC_NAMES
    mov_vec = torch.stack([vals[name] for name in names], dim=-1)
    di = pipe.cognitive(mov_vec, pipe.settings.clamp_movs)
    return mov_vec, di, NN.odg(di)


# ---------------------------------------------------------------------------
# The host side: buffers, chunk dispatch and readings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StreamResult:
    odg: float
    di: float
    movs: dict[str, float]


@dataclasses.dataclass
class PoolResult:
    """Per-stream results: odg/di are [N] float arrays; movs maps each MOV
    name to an [N] float array."""
    odg: np.ndarray
    di: np.ndarray
    movs: dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class _Path:
    """One path's chunk step and framing: a chunk of `take` samples is
    stepped whenever a path's buffers hold `need`; frames of `frame`
    samples every `hop`."""
    step: object
    need: int
    take: int
    frame: int
    hop: int


@dataclasses.dataclass(frozen=True)
class ChunkStep:
    """One path's chunk step on one part of a pool, to be driven on chunks
    already on the device: run(state, ref, test) returns the new state, on
    ref/test [streams, CH, need] on `device`; each step advances the path
    by `take` samples."""
    run: object
    need: int
    take: int
    streams: int
    device: torch.device


def _run_step(step, pipe, state, ref, test):
    with api.full_precision_matmuls(), torch.inference_mode():
        return step(pipe, state, ref, test)


class _Streams:
    """N streams advanced in lockstep on one device, the engine of the
    three public classes.  The state (leaves [N, ...]) stays on the device;
    the host keeps, per path and signal, the pending samples [N, T, CH]
    (less than a chunk; `pending`) and ships each chunk as [N, CH, T].

    A checkpoint holds the device state only, as in the JAX package: to
    resume bit for bit, restore `state` from it and `pending` from the
    interrupted stream, or feed the audio that follows what the state
    covers."""

    def __init__(self, n_streams: int, channels: int, chunk_frames: int,
                 playback_level: float, settings: C.Settings, dtype,
                 advanced: bool, device):
        if n_streams < 1 or channels < 1 or chunk_frames < 1:
            raise ValueError("n_streams, channels and chunk_frames must be "
                             "positive")
        self._device = api.resolve_device(device)
        self._pipe = batch_pipeline(advanced, playback_level, settings,
                                    dtype or api.DEFAULT_DTYPE, self._device)
        self._n, self._channels = n_streams, channels
        self._advanced = advanced
        hop = C.FFT_STEPSIZE
        fft_take = chunk_frames * hop
        if advanced:
            fb_take = chunk_frames * 16 * C.FB_FRAMESIZE   # ~the same span
            self._paths = (
                _Path(fft_chunk_step, fft_take + hop, fft_take,
                      C.FFT_FRAMESIZE, hop),
                _Path(fb_chunk_step, fb_take, fb_take, C.FB_FRAMESIZE,
                      C.FB_FRAMESIZE))
            one = init_advanced_state(self._pipe, channels)
            self._names = C.MOV_ADVANCED_NAMES
        else:
            self._paths = (_Path(basic_chunk_step, fft_take + hop, fft_take,
                                 C.FFT_FRAMESIZE, hop),)
            one = init_basic_state(self._pipe, channels)
            self._names = C.MOV_BASIC_NAMES
        self._state = tree_map(
            lambda x: x[None].repeat(n_streams, *[1] * x.dim()), one)
        self.pending = [[self._empty(), self._empty()] for _ in self._paths]
        self._finalized = False

    def _empty(self) -> np.ndarray:
        return np.zeros((self._n, 0, self._channels), np.float32)

    def _step(self, path: _Path, ref: np.ndarray, test: np.ndarray) -> None:
        """One chunk step on [N, T, CH] host samples."""
        def ship(x):
            return torch.from_numpy(
                np.ascontiguousarray(np.swapaxes(x, 1, 2))).to(self._device)

        self._state = _run_step(path.step, self._pipe, self._state,
                                ship(ref), ship(test))

    def _feed3(self, ref: np.ndarray, test: np.ndarray) -> None:
        """Append [N, T, CH] samples of each signal and run every chunk
        they complete."""
        if self._finalized:
            raise RuntimeError("the stream is finalized")
        for bufs in self.pending:
            bufs[0] = _cat_ship(bufs[0], ref)
            bufs[1] = _cat_ship(bufs[1], test)
        for path, bufs in zip(self._paths, self.pending):
            while min(b.shape[1] for b in bufs) >= path.need:
                self._step(path, bufs[0][:, :path.need],
                           bufs[1][:, :path.need])
                bufs[0] = bufs[0][:, path.take:]
                bufs[1] = bufs[1][:, path.take:]

    def _read(self) -> np.ndarray:
        """[N, 2 + M] float64 on the host: ODG, DI, then the MOVs."""
        with api.full_precision_matmuls(), torch.inference_mode():
            movs, di, odg = read_movs(self._pipe, self._state,
                                      self._advanced)
            out = torch.cat([odg[:, None], di[:, None], movs], dim=-1)
            return out.to(torch.float64).cpu().numpy()

    def _finalize(self) -> None:
        """Run the pending full frames and the zero-padded flush frame of
        each path (src/gstpeaq.c:715-745)."""
        if self._finalized:
            return
        for path, bufs in zip(self._paths, self.pending):
            n_rest = framing.num_frames(bufs[0].shape[1], bufs[1].shape[1],
                                        path.frame, path.hop)
            if n_rest > 0:
                length = framing.padded_length(n_rest, path.frame, path.hop)
                self._step(path, *(_padded(b, length) for b in bufs))
            bufs[:] = [self._empty(), self._empty()]
        self._finalized = True


def _padded(buf: np.ndarray, length: int) -> np.ndarray:
    """[N, T, CH] zero-padded or cut to `length` samples."""
    out = np.zeros((buf.shape[0], length, buf.shape[2]), buf.dtype)
    take = min(length, buf.shape[1])
    out[:, :take] = buf[:, :take]
    return out


class _ScalarStream(_Streams):
    """One stream: feeds [T] / [T, CH] pieces, ref and test of any lengths,
    and `state` in the JAX package's scalar layout."""

    def __init__(self, advanced: bool, channels: int, chunk_frames: int,
                 playback_level: float, settings: C.Settings, dtype, device):
        super().__init__(1, channels, chunk_frames, playback_level, settings,
                         dtype, advanced, device)

    @property
    def state(self):
        return tree_map(lambda x: x[0], self._state)

    @state.setter
    def state(self, value):
        self._state = tree_map(lambda x: x[None], value)

    def feed(self, ref, test) -> None:
        """Append arbitrary-length pieces [T] / [T, CH] (float, or int16
        PCM, which ships raw) of both signals and run every complete
        chunk."""
        r, t = as_2d_ship(ref), as_2d_ship(test)
        if r.shape[1] != self._channels or t.shape[1] != self._channels:
            raise ValueError(f"the stream has {self._channels} channel(s), "
                             f"got {r.shape[1]} and {t.shape[1]}")
        self._feed3(r[None], t[None])

    def current(self) -> StreamResult:
        """ODG, DI and MOVs of everything fed so far."""
        row = self._read()[0]
        return StreamResult(odg=float(row[0]), di=float(row[1]),
                            movs=dict(zip(self._names, map(float, row[2:]))))

    def finalize(self) -> StreamResult:
        """Process the remaining full frames and the zero-padded flush
        frame, and return the final result."""
        self._finalize()
        return self.current()


class PeaqStream(_ScalarStream):
    """Streaming basic PEAQ with O(1) memory in the program's length.

    feed() takes arbitrary-length [T] / [T, CH] float32 (or int16) pieces
    of both signals; current() gives the result of everything fed so far
    (the reference's query-at-any-time property); finalize() flushes the
    trailing partial frame (src/gstpeaq.c:715-745) and returns the final
    result.  device: a torch device, None meaning CUDA (raises without
    it); dtype: a precision tier of api.DTYPES.  The state is `state`, a
    tree of tensors on the device; utils/checkpoint.py saves and loads
    it."""

    def __init__(self, channels: int = 2, chunk_frames: int = 64,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, device=None):
        super().__init__(False, channels, chunk_frames, playback_level,
                         settings, dtype, device)


class PeaqStreamAdvanced(_ScalarStream):
    """Streaming advanced PEAQ: two paths, the FFT path (frames 2048, hop
    1024, chunks of chunk_frames frames) and the filter-bank path (frames
    192, chunks of 16 chunk_frames frames, about the same span), each with
    its own buffers, as the reference's four GstAdapters
    (src/gstpeaq.c:117-120, 645-652).  Otherwise as PeaqStream."""

    def __init__(self, channels: int = 2, chunk_frames: int = 64,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, device=None):
        super().__init__(True, channels, chunk_frames, playback_level,
                         settings, dtype, device)


class PeaqStreamPool:
    """N long-form streams advanced in lockstep by one chunk step at N
    streams: every kernel launches once per chunk for all of them.  The
    same steps and state semantics as PeaqStream / PeaqStreamAdvanced, with
    a leading [N] axis on every state leaf (the JAX pool's layout), so
    utils/checkpoint.py saves it as it is.

    Lockstep: every feed() advances every stream by the same sample count,
    ref/test [N, T] or [N, T, CH].  Streams of different lengths belong in
    separate pools (or pad the short ones and read current() before their
    tails).

    `device`: one torch device (None: CUDA), or a list of devices (the JAX
    pool's mesh): the stream axis is split into equal parts, one pool of
    N / len(device) streams per device in stream order, and n_streams must
    be a multiple of the device count.  Each part's chunk steps run on its
    device; `state` joins the parts' leaves in stream order on the first
    device, so a checkpoint is the one a pool on one device writes."""

    def __init__(self, n_streams: int, channels: int = 2,
                 chunk_frames: int = 64, playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype: str | None = None, advanced: bool = False,
                 device=None):
        devices = (list(device) if isinstance(device, (list, tuple))
                   else [device])
        if not devices or n_streams % len(devices):
            raise ValueError(f"n_streams {n_streams} is not a multiple of "
                             f"the {len(devices)} device(s)")
        self._per = n_streams // len(devices)
        self._parts = [_Streams(self._per, channels, chunk_frames,
                                playback_level, settings, dtype, advanced,
                                dev)
                       for dev in devices]
        self._n, self._channels = n_streams, channels
        self._names = self._parts[0]._names

    @property
    def state(self):
        parts = [tree_flatten(part._state) for part in self._parts]
        return tree_unflatten(self._parts[0]._state, [
            torch.cat([leaf.to(leaves[0].device) for leaf in leaves])
            for leaves in zip(*parts)])

    @state.setter
    def state(self, value):
        leaves = tree_flatten(value)
        for i, part in enumerate(self._parts):
            part._state = tree_unflatten(part._state, [
                leaf[i * self._per:(i + 1) * self._per].to(place.device)
                for leaf, place in zip(leaves, tree_flatten(part._state))])

    def chunk_steps(self) -> tuple[list[list[ChunkStep]], list]:
        """(steps, states) for driving the pool's chunk steps directly on
        chunks staged on the device, with the host's transfers off the
        clock (tools/longform_bench.py --device-source): steps[path][part]
        per path (the FFT path, then the advanced version's FB path) and
        part (in stream order), and each part's current state.  The pool
        itself does not advance."""
        steps = [[ChunkStep(functools.partial(_run_step, path.step,
                                              part._pipe),
                            path.need, path.take, self._per, part._device)
                  for part in self._parts]
                 for path in self._parts[0]._paths]
        return steps, [part._state for part in self._parts]

    def _as3(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.dtype != np.int16:                 # int16 PCM ships raw
            x = x.astype(np.float32, copy=False)
        if x.ndim == 2:
            x = x[:, :, None]
        if x.ndim != 3 or x.shape[0] != self._n \
                or x.shape[2] != self._channels:
            raise ValueError(f"pool feeds are [{self._n}, T] or [{self._n}, "
                             f"T, {self._channels}], got {x.shape}")
        return x

    def feed(self, ref, test) -> None:
        """Append [N, T] / [N, T, CH] samples of both signals, the same T
        for every stream and for both signals, and run every complete
        chunk: each part's steps on its device, every part's queued
        before any result is read."""
        r, t = self._as3(ref), self._as3(test)
        if r.shape[1] != t.shape[1]:
            raise ValueError(
                f"PeaqStreamPool.feed is lockstep: ref and test must carry "
                f"the same sample count per feed (got {r.shape[1]} vs "
                f"{t.shape[1]}); use PeaqStream for skewed feeds")
        per = self._per
        for i, part in enumerate(self._parts):
            part._feed3(r[i * per:(i + 1) * per], t[i * per:(i + 1) * per])

    def current(self) -> PoolResult:
        out = np.concatenate([part._read() for part in self._parts])
        return PoolResult(odg=out[:, 0], di=out[:, 1],
                          movs={name: out[:, 2 + i]
                                for i, name in enumerate(self._names)})

    def finalize(self) -> PoolResult:
        """Process the remaining full frames and the zero-padded flush
        frame (lockstep: every stream flushes at the same boundary)."""
        for part in self._parts:
            part._finalize()
        return self.current()
