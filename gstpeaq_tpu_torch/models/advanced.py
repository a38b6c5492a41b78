"""Advanced-version PEAQ pipeline (FFT and filter-bank ear models, 5 MOVs)
over a batch of pairs (one pair is a batch of one).

Two paths over the same audio, each with its own frame count and
data-boundary gating (kernel G1 on each), as in the reference
(src/gstpeaq.c:923-1010):

  FFT path  the 55-band FFT ear at frame 2048 / hop 1024, with only the
            reference grouped and spread (kernel K3) and smeared (K1),
            feeding SegmentalNMRB and EHSB;
  FB path   the 40-band filter-bank ear at frame 192 on ref and test of
            every channel at once (ops/fb_ear.py: kernels D3, D1, D2, K1),
            the level adapter and modulation processors at step 192 (K2,
            K1), feeding RmsModDiffA, RmsNoiseLoudAsymA and AvgLinDistA.

The five MOVs go through the advanced cognitive network to DI and ODG.
Pairs of one batch share each path's frame count (its bucket); each pair's
frames past its own count of that path are masked out (basic.py).
`AdvancedPipeline.unified_input` takes both paths' audio as one array.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import constants as C
from .. import earparams as EP
from ..ops import cuda_gate
from ..ops import exact
from ..ops import fb_ear as FB
from ..ops import fft_ear as FE
from ..ops import framing
from . import accum
from . import level_adapt as LA
from . import movs as MOVS
from . import nn as NN
from .basic import (channel_mean, energy_totals, frame_major,
                    loudness_gates, valid_mask)


class AdvancedOutputs(NamedTuple):
    odg: torch.Tensor           # [B]
    di: torch.Tensor            # [B]
    movs: torch.Tensor          # [B, 5] in MOV_ADVANCED_NAMES order
    total_signal_energy: torch.Tensor   # [B]
    total_noise_energy: torch.Tensor    # [B]


class AdvancedPipeline(nn.Module):
    """The advanced model's constants (both ear models, the 40-band average,
    the EHS window, the cognitive network) as buffers on `device`, and the
    pipeline as its forward.

    `dtype` is the band-domain dtype, `spectrum_dtype` (default `dtype`)
    the spectrum and sample-domain one, as in gstpeaq_tpu/models/
    advanced.py::make_pipeline: the FFT path's frames, spectra, NMR noise
    spectrum and EHS, the FB path's DC stage and FIR bank, both threshold
    gates and the energy totals run in the spectrum dtype; the band chains
    in `dtype`.  MOVs that mix the two come out in the wider, and so does
    the cognitive network."""

    def __init__(self, playback_level: float = 92.0,
                 settings: C.Settings = C.DEFAULT_SETTINGS,
                 dtype=torch.float64, device="cpu", spectrum_dtype=None):
        super().__init__()
        sdtype = spectrum_dtype or dtype
        self.settings = settings
        self.fft = FE.build_consts(
            EP.fft_ear_params(C.ADVANCED_FFT_BAND_COUNT, playback_level),
            dtype, device, sdtype)
        self.fb = FB.build_consts(
            EP.fb_ear_params(playback_level), dtype, device,
            swap_slope=settings.swap_slope_filter_coefficients,
            spectrum_dtype=sdtype)
        self.register_buffer("avg_matrix", torch.as_tensor(
            LA.sliding_average_matrix(C.FB_BAND_COUNT), dtype=dtype,
            device=device))
        self.register_buffer("ehs_window", torch.as_tensor(
            EP.ehs_correlation_window(settings.center_ehs_correlation_window),
            dtype=sdtype, device=device))
        self.cognitive = NN.CognitiveModel.standard(
            True, torch.promote_types(dtype, sdtype), device)

    def unified_input(self, sig_pair: torch.Tensor, n_fft: int, n_fb: int,
                      valid_fft: torch.Tensor | None = None,
                      valid_fb: torch.Tensor | None = None) -> AdvancedOutputs:
        """forward on ONE array of both paths' audio (gstpeaq_tpu/models/
        advanced.py::unified_input, flat form): sig_pair [2(ref, test), B,
        CH, Tmax] with Tmax = max((n_fft + 1) * 1024, 192 n_fb), each
        pair's audio truncated at min(Tmax, its length) and zero-padded.
        Each path reads its prefix as a view; frames past a pair's own
        flush frame may carry its audio, and valid_fft / valid_fb (each
        pair's own frame counts) mask them out; every consumer is gated
        and every recurrence causal, so they reach no unmasked frame."""
        sig_pair = framing.dequantize(sig_pair)
        t_fft = (n_fft + 1) * C.FFT_STEPSIZE
        return self(sig_pair[0, ..., :t_fft], sig_pair[1, ..., :t_fft],
                    sig_pair[..., :n_fb * C.FB_FRAMESIZE], valid_fft,
                    valid_fb)

    def forward(self, ref_fft: torch.Tensor, test_fft: torch.Tensor,
                fb_pair: torch.Tensor, valid_fft: torch.Tensor | None = None,
                valid_fb: torch.Tensor | None = None) -> AdvancedOutputs:
        """ref/test_fft: [B, CH, T] with T = (F_fft + 1) * 1024; fb_pair:
        [2(ref, test), B, CH, 192 F_fb]; each zero-padded on the host past
        each pair's own flush frame of its path; valid_fft / valid_fb: [B]
        int, each pair's own frame count of the path, or None when it is
        the bucket's for every pair."""
        kf, kb = self.fft, self.fb
        settings = self.settings
        sdtype = kf.hann.dtype                     # the spectrum dtype
        fm = frame_major                           # [B, CH, F] -> [F, B, CH]
        ch_mean = channel_mean                     # [B, CH] -> [B]

        # ------------------ FFT path: SegmentalNMR + EHS ------------------
        ref_fft = framing.dequantize(ref_fft)
        test_fft = framing.dequantize(test_fft)
        n_fft = ref_fft.shape[-1] // C.FFT_STEPSIZE - 1
        above_fft = cuda_gate.frame_gate(ref_fft, n_fft, C.FFT_FRAMESIZE,
                                         C.FFT_STEPSIZE, sdtype)
        fft_valid = valid_mask(n_fft, valid_fft, ref_fft.device)
        if fft_valid is not None:
            above_fft = above_fft & fft_valid
        _, _, committed_fft = accum.activity(above_fft.T)   # [F, B]
        rblocks = framing.blocks_hop(ref_fft, n_fft)   # [B, CH, F+1, 1024]
        tblocks = framing.blocks_hop(test_fft, n_fft)
        ear = FE.stateless_pair_movs(kf, rblocks, tblocks,
                                     spread_ref_only=True, bandwidth=False)
        ref_exc = FE.time_smear(
            kf, ear.unsmeared.transpose(-1, -2).contiguous(), axis=-1)
        nmr_mean, _ = MOVS.nmr_from_bands(
            kf.masking_difference, ear.noise_in_bands,
            ref_exc.transpose(-1, -2))
        ehs_val, ehs_valid = MOVS.ehs_from_difference(
            ear.ehs_difference, ear.threshold[0], ear.threshold[1], settings,
            self.ehs_window)
        cmf = committed_fft[..., None]
        one = torch.ones_like(fm(nmr_mean))
        seg_nmr = ch_mean(accum.avg(10.0 * exact.log10(fm(nmr_mean)), one,
                                    cmf))
        ehs_mov = ch_mean(accum.avg(fm(ehs_val), one,
                                    cmf & ehs_valid.T[..., None]))

        # ------------- FB path: ModDiff / NoiseLoudAsym / LinDist ----------
        fb_pair = framing.dequantize(fb_pair)
        n_fb = fb_pair.shape[-1] // C.FB_FRAMESIZE
        above_fb = cuda_gate.frame_gate(fb_pair[0], n_fb, C.FB_FRAMESIZE,
                                        C.FB_FRAMESIZE, sdtype)
        fb_pair = fb_pair.to(sdtype)
        fb_valid = valid_mask(n_fb, valid_fb, fb_pair.device)
        if fb_valid is not None:
            above_fb = above_fb & fb_valid
        _, _, committed_fb = accum.activity(above_fb.T)     # [F, B]
        exc2, uns2 = FB.process_signal(kb, fb_pair, n_fb)  # [2,B,CH,40,F]
        ref_e = exc2[0]
        adapted_ref, adapted_test, mod2, avg_loud2 = LA.level_adapt_fused_mod(
            kb.adapt_a, self.avg_matrix, exc2, uns2, C.FB_FRAMESIZE)
        mod_ref, mod_test = mod2[0], mod2[1]
        md_gate, nl_gate = loudness_gates(FE.loudness(kb, exc2, axis=-2),
                                          125, 13)

        md1, _, temp_wt = (fm(x) for x in MOVS.modulation_difference(
            kb.internal_noise, mod_ref, mod_test, avg_loud2[0],
            rms_mode=True, lev_wt=1.0))
        noise = kb.internal_noise
        nl_asym = fm(MOVS.noise_loudness(
            noise, 2.5, 0.3, 1.0, 0.1, mod_ref, mod_test, adapted_ref,
            adapted_test))
        if settings.swap_mod_patts_for_noise_loudness_movs:
            missing = fm(MOVS.noise_loudness(
                noise, 1.5, 0.15, 1.0, 0.0, mod_test, mod_ref, adapted_test,
                adapted_ref))
            lin_dist = fm(MOVS.noise_loudness(
                noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_ref, adapted_ref,
                ref_e))
        else:
            missing = fm(MOVS.noise_loudness(
                noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_test, adapted_test,
                adapted_ref))
            lin_dist = fm(MOVS.noise_loudness(
                noise, 1.5, 0.15, 1.0, 0.0, mod_ref, mod_test, adapted_ref,
                ref_e))

        cmb = committed_fb[..., None]
        nl_mask = cmb & nl_gate.T[..., None]
        mov = {
            "RmsModDiffA": ch_mean(
                accum.rms(md1, temp_wt, cmb & md_gate[:, None, None])),
            "RmsNoiseLoudAsymA": ch_mean(
                accum.rms_asym(nl_asym, missing, nl_mask)),
            "SegmentalNMRB": seg_nmr,
            "EHSB": ehs_mov,
            "AvgLinDistA": ch_mean(
                accum.avg(lin_dist, torch.ones_like(md1), nl_mask)),
        }
        mov_vec = torch.stack([mov[name] for name in C.MOV_ADVANCED_NAMES],
                              -1)
        di = self.cognitive(mov_vec, settings.clamp_movs)
        signal_energy, noise_energy = energy_totals(ear.halves, fft_valid)
        return AdvancedOutputs(odg=NN.odg(di), di=di, movs=mov_vec,
                               total_signal_energy=signal_energy,
                               total_noise_energy=noise_energy)
