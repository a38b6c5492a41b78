"""Basic-version PEAQ pipeline (FFT ear model, 11 MOVs) over a batch of
pairs.

`BasicPipeline.forward` maps padded 48 kHz signals [B, CH, T] (a batch of B
pairs; one pair is B = 1) to ODG, DI and the MOVs per pair in three stages:

  A  the stateless ear model over all frames and channels (frames: S1,
     rDFT, the bin-domain stage: S2, spreading: K3);
  B  the recurrences over frames: time smearing (K1), the level adapter's
     stage-1 and the modulation smoothers (K2), the level adapter's
     num/den and pattern-correction smoothers (K1 twice);
  C  per-frame MOV terms, masked accumulation and the cognitive model.

The orchestration follows src/gstpeaq.c:849-921: the frame >= 24 gates, the
loudness-reached +3 delay, the data-boundary masks (the gate: kernel G1,
ops/cuda_gate.py; accum.py), binaural ADB/MFPD, the trailing zero-padded
flush frame (padded on the host) and the totalsnr sums (S1's halves).
Pairs of one batch share a frame count (a bucket, parallel/batch.py); each
pair's frames past its own count are masked out as the reference never
processes them, so a batch gives each pair what it gives alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import constants as C
from .. import earparams as EP
from ..ops import cuda_gate
from ..ops import fft_ear as FE
from ..ops import framing
from . import accum
from . import level_adapt as LA
from . import movs as MOVS
from . import nn as NN


class BasicOutputs(NamedTuple):
    odg: torch.Tensor           # [B]
    di: torch.Tensor            # [B]
    movs: torch.Tensor          # [B, 11] in MOV_BASIC_NAMES order
    total_signal_energy: torch.Tensor   # [B]
    total_noise_energy: torch.Tensor    # [B]


def frame_major(x: torch.Tensor) -> torch.Tensor:
    """[B, CH, F] -> the accumulators' [F, B, CH]."""
    return x.movedim(-1, 0)


def channel_mean(x: torch.Tensor) -> torch.Tensor:
    """An accumulated MOV [B, CH] -> [B], the mean over each pair's
    channels (the reference's multichannel average)."""
    return torch.mean(x, dim=-1)


def loudness_gates(loud2: torch.Tensor, start: int, delay: int):
    """The MOV gates per frame from the overall loudness loud2 [2, B, CH, F]
    of (ref, test): md_gate [F], frames >= start, and nl_gate [B, F], which
    also needs the pair's loudness reached in both signals of some channel
    `delay` frames before; src/gstpeaq.c:841-845,880-886 (basic: start 24,
    delay 3) and :988,996-997 (advanced: 125, 13)."""
    loud_ok = torch.any((loud2[0] > 0.1) & (loud2[1] > 0.1), dim=-2)
    f_idx = torch.arange(loud_ok.shape[-1], device=loud_ok.device)
    # the first frame where reached, per pair
    loud_frame = torch.argmax(loud_ok.to(torch.int32), dim=-1, keepdim=True)
    md_gate = f_idx >= start
    nl_gate = (md_gate & torch.any(loud_ok, dim=-1, keepdim=True)
               & (f_idx - delay >= loud_frame))
    return md_gate, nl_gate


def valid_mask(n_frames: int, valid, device):
    """[B, F] bool: frame < the pair's own frame count, or None when every
    frame of the bucket is the pair's own (valid is None)."""
    if valid is None:
        return None
    return torch.arange(n_frames, device=device) < valid[:, None]


def energy_totals(halves: torch.Tensor, frame_valid):
    """totalsnr bookkeeping per pair (src/gstpeaq.c:913-918): the sums over
    channels and frames of S1's halves [2, B, CH, F], the energies of each
    frame's first half (hop block f) of ref and of ref - test; frames past
    a pair's own count (frame_valid [B, F] False) are left out.  Returns
    (signal, noise), each [B]."""
    if frame_valid is not None:
        halves = torch.where(frame_valid[:, None, :], halves, 0.0)
    signal, noise = torch.sum(halves, dim=(-2, -1))
    return signal, noise


class BasicPipeline(nn.Module):
    """The basic model's constants (ear model, band average, EHS window,
    cognitive network) as buffers on `device`, and the pipeline as its
    forward.

    `dtype` is the band-domain dtype, `spectrum_dtype` (default `dtype`)
    the bin-domain one, as in gstpeaq_tpu/models/basic.py::make_pipeline:
    the frames, spectra, threshold gate, bandwidth, NMR's noise spectrum,
    EHS and the energy totals run in the spectrum dtype, the band chain in
    `dtype`.  MOVs that mix the two come out in the wider (JAX's type
    promotion), and so does the cognitive network."""

    def __init__(self, band_count: int = C.BASIC_BAND_COUNT,
                 playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype=torch.float64, device="cpu", spectrum_dtype=None):
        super().__init__()
        sdtype = spectrum_dtype or dtype
        self.settings = settings
        self.consts = FE.build_consts(
            EP.fft_ear_params(band_count, playback_level), dtype, device,
            sdtype)
        self.register_buffer("avg_matrix", torch.as_tensor(
            LA.sliding_average_matrix(band_count), dtype=dtype,
            device=device))
        self.register_buffer("ehs_window", torch.as_tensor(
            EP.ehs_correlation_window(settings.center_ehs_correlation_window),
            dtype=sdtype, device=device))
        self.cognitive = NN.CognitiveModel.standard(
            False, torch.promote_types(dtype, sdtype), device)

    def forward(self, ref_sig: torch.Tensor, test_sig: torch.Tensor,
                valid_frames: torch.Tensor | None = None) -> BasicOutputs:
        """ref/test_sig: [B, CH, T] float (or PCM16) with T = (F + 1) * 1024,
        zero-padded on the host past each pair's own flush frame;
        valid_frames: [B] int, each pair's own frame count (<= F), or None
        when it is F for every pair."""
        k = self.consts
        settings = self.settings
        sdtype = k.hann.dtype                      # the spectrum dtype
        ref_sig = framing.dequantize(ref_sig)
        test_sig = framing.dequantize(test_sig)
        n_frames = ref_sig.shape[-1] // C.FFT_STEPSIZE - 1
        above = cuda_gate.frame_gate(ref_sig, n_frames, C.FFT_FRAMESIZE,
                                     C.FFT_STEPSIZE, sdtype)
        frame_valid = valid_mask(n_frames, valid_frames, ref_sig.device)
        if frame_valid is not None:
            # frames past a pair's own flush frame can still overlap its
            # audio (50% overlap): leave them out as the reference does
            above = above & frame_valid
        _, active, committed = accum.activity(above.T)       # [F, B]
        ref_blocks = framing.blocks_hop(ref_sig, n_frames)   # [B,CH,F+1,1024]
        test_blocks = framing.blocks_hop(test_sig, n_frames)

        # ---- stage A: stateless ear model on both signals ----
        ear = FE.stateless_pair_movs(k, ref_blocks, test_blocks)

        # ---- stage B: recurrences over frames, in [2, B, CH, Z, F] ----
        uns_t = ear.unsmeared.transpose(-1, -2).contiguous()
        exc = FE.time_smear(k, uns_t, axis=-1)
        ref_e, test_e = exc[0], exc[1]                     # [B, CH, Z, F]
        adapted_ref, adapted_test, mod2, avg_loud2 = LA.level_adapt_fused_mod(
            k.adapt_a, self.avg_matrix, exc, uns_t, C.FFT_STEPSIZE)
        mod_ref, mod_test = mod2[0], mod2[1]
        md_gate, nl_gate = loudness_gates(FE.loudness(k, exc, axis=-2),
                                          24, 3)

        # ---- stage C: per-frame MOV terms, then [B, CH, F] -> [F, B, CH] ----
        fm = frame_major
        md1, md2, temp_wt = (fm(x) for x in MOVS.modulation_difference(
            k.internal_noise, mod_ref, mod_test, avg_loud2[0],
            rms_mode=False, lev_wt=100.0))
        nl = fm(MOVS.noise_loudness(
            k.internal_noise, 1.5, 0.15, 0.5, 0.0, mod_ref, mod_test,
            adapted_ref, adapted_test))
        bw_ref, bw_test, bw_valid = (fm(x) for x in ear.bandwidth)
        nmr_mean, disturbed = (fm(x) for x in MOVS.nmr_from_bands(
            k.masking_difference, ear.noise_in_bands,
            ref_e.transpose(-1, -2)))
        p_bin, steps_bin = (x.T for x in MOVS.prob_detect(
            ref_e, test_e, settings.use_floor_for_steps_above_threshold))
        ehs_val, ehs_valid = MOVS.ehs_from_difference(
            ear.ehs_difference, ear.threshold[0], ear.threshold[1], settings,
            self.ehs_window)
        ehs_val = fm(ehs_val)

        # ---- accumulate, [F, B, CH] -> [B] ----
        cm = committed[..., None]
        gm = md_gate[:, None, None]
        one = torch.ones_like(md1)
        ch_mean = channel_mean
        mov = {
            "BandwidthRefB": ch_mean(accum.avg(bw_ref, one, cm & bw_valid)),
            "BandwidthTestB": ch_mean(accum.avg(bw_test, one, cm & bw_valid)),
            "TotalNMRB": ch_mean(accum.avg_log(nmr_mean, one, cm)),
            "WinModDiff1B": ch_mean(accum.avg_window(
                md1, active[..., None] & gm, cm)),
            "ADBB": accum.adb(steps_bin, committed & (p_bin > 0.5)),
            "EHSB": ch_mean(accum.avg(ehs_val, one,
                                      cm & ehs_valid.T[..., None])),
            "AvgModDiff1B": ch_mean(accum.avg(md1, temp_wt, cm & gm)),
            "AvgModDiff2B": ch_mean(accum.avg(md2, temp_wt, cm & gm)),
            "RmsNoiseLoudB": ch_mean(accum.rms(nl, one,
                                               cm & nl_gate.T[..., None])),
            "MFPDB": accum.filtered_max(p_bin, active, committed),
            "RelDistFramesB": ch_mean(accum.avg(disturbed, one, cm)),
        }
        mov_vec = torch.stack([mov[name] for name in C.MOV_BASIC_NAMES], -1)
        di = self.cognitive(mov_vec, settings.clamp_movs)
        signal_energy, noise_energy = energy_totals(ear.halves, frame_valid)
        return BasicOutputs(odg=NN.odg(di), di=di, movs=mov_vec,
                            total_signal_energy=signal_energy,
                            total_noise_energy=noise_energy)
