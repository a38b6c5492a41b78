"""Advanced-version PEAQ pipeline (FFT and filter-bank ear models, 5 MOVs)
for one pair.

Two paths over the same audio, each with its own frame count and
data-boundary gating, as in the reference (src/gstpeaq.c:923-1010):

  FFT path  the 55-band FFT ear at frame 2048 / hop 1024, with only the
            reference grouped and spread (kernel K3) and smeared (K1),
            feeding SegmentalNMRB and EHSB;
  FB path   the 40-band filter-bank ear at frame 192 on ref and test of
            every channel at once (ops/fb_ear.py: kernels D3, D1, D2, K1),
            the level adapter and modulation processors at step 192 (K2,
            K1), feeding RmsModDiffA, RmsNoiseLoudAsymA and AvgLinDistA.

The five MOVs go through the advanced cognitive network to DI and ODG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import constants as C
from .. import earparams as EP
from ..ops import fb_ear as FB
from ..ops import fft_ear as FE
from ..ops import framing
from . import accum
from . import level_adapt as LA
from . import movs as MOVS
from . import nn as NN


class AdvancedOutputs(NamedTuple):
    odg: torch.Tensor
    di: torch.Tensor
    movs: torch.Tensor          # [5] in MOV_ADVANCED_NAMES order
    total_signal_energy: torch.Tensor
    total_noise_energy: torch.Tensor


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

    def forward(self, ref_fft: torch.Tensor, test_fft: torch.Tensor,
                fb_pair: torch.Tensor) -> AdvancedOutputs:
        """ref/test_fft: [CH, T] with T = (F_fft + 1) * 1024; fb_pair:
        [2(ref, test), CH, 192 F_fb]; each zero-padded on the host past the
        pair's own flush frame of its path."""
        kf, kb = self.fft, self.fb
        settings = self.settings
        sdtype = kf.hann.dtype                     # the spectrum dtype

        def fm(x):
            """[CH, F] -> the accumulators' [F, CH]."""
            return x.transpose(-1, -2)

        # ------------------ FFT path: SegmentalNMR + EHS ------------------
        ref_fft = framing.dequantize(ref_fft)
        test_fft = framing.dequantize(test_fft)
        n_fft = ref_fft.shape[-1] // C.FFT_STEPSIZE - 1
        above_fft = framing.above_threshold_signal(
            ref_fft.to(sdtype), n_fft, C.FFT_FRAMESIZE, C.FFT_STEPSIZE)
        _, _, committed_fft = accum.activity(above_fft)
        rblocks = framing.blocks_hop(ref_fft, n_fft)       # [CH, F+1, 1024]
        tblocks = framing.blocks_hop(test_fft, n_fft)
        power, ref_uns, thresh, delta_p = FE.stateless_pair_hop(
            kf, rblocks, tblocks, spread_ref_only=True)
        ref_exc = FE.time_smear(
            kf, ref_uns.transpose(-1, -2).contiguous(), axis=-1)
        hi = kf.group_bin_hi
        nmr_mean, _ = MOVS.nmr(
            kf.group_matrix[:hi], kf.masking_difference, power[0][..., :hi],
            power[1][..., :hi], ref_exc.transpose(-1, -2), delta_p)
        ehs_val, ehs_valid = MOVS.ehs(
            power[0], power[1], thresh[0], thresh[1], settings,
            self.ehs_window, delta_p, kf.ehs_zero)
        cmf = committed_fft[:, None]
        one = torch.ones_like(fm(nmr_mean))
        seg_nmr = torch.mean(accum.avg(10.0 * torch.log10(fm(nmr_mean)), one,
                                       cmf))
        ehs_mov = torch.mean(accum.avg(fm(ehs_val), one,
                                       cmf & ehs_valid[:, None]))

        # ------------- FB path: ModDiff / NoiseLoudAsym / LinDist ----------
        fb_pair = framing.dequantize(fb_pair).to(sdtype)
        n_fb = fb_pair.shape[-1] // C.FB_FRAMESIZE
        above_fb = framing.above_threshold_signal(
            fb_pair[0], n_fb, C.FB_FRAMESIZE, C.FB_FRAMESIZE)
        _, _, committed_fb = accum.activity(above_fb)
        exc2, uns2 = FB.process_signal(kb, fb_pair, n_fb)   # [2, CH, 40, F]
        ref_e = exc2[0]
        adapted_ref, adapted_test, mod2, avg_loud2 = LA.level_adapt_fused_mod(
            kb.adapt_a, self.avg_matrix, exc2, uns2, C.FB_FRAMESIZE)
        mod_ref, mod_test = mod2[0], mod2[1]

        # loudness gate; src/gstpeaq.c:988,996-997
        loud2 = FE.loudness(kb, exc2, axis=-2)             # [2, CH, F]
        loud_ok = torch.any((loud2[0] > 0.1) & (loud2[1] > 0.1), dim=-2)
        f_idx = torch.arange(n_fb, device=loud_ok.device)
        loud_frame = torch.argmax(loud_ok.to(torch.int32))  # first reached
        md_gate = f_idx >= 125
        nl_gate = md_gate & torch.any(loud_ok) & (f_idx - 13 >= loud_frame)

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

        cmb = committed_fb[:, None]
        nl_mask = cmb & nl_gate[:, None]
        mov = {
            "RmsModDiffA": torch.mean(
                accum.rms(md1, temp_wt, cmb & md_gate[:, None])),
            "RmsNoiseLoudAsymA": torch.mean(
                accum.rms_asym(nl_asym, missing, nl_mask)),
            "SegmentalNMRB": seg_nmr,
            "EHSB": ehs_mov,
            "AvgLinDistA": torch.mean(
                accum.avg(lin_dist, torch.ones_like(md1), nl_mask)),
        }
        mov_vec = torch.stack([mov[name] for name in C.MOV_ADVANCED_NAMES])
        di = self.cognitive(mov_vec, settings.clamp_movs)

        # totalsnr bookkeeping: the first half of FFT frame f is hop block f
        rhalf = rblocks[..., :-1, :].to(sdtype)
        nhalf = rhalf - tblocks[..., :-1, :].to(sdtype)
        return AdvancedOutputs(odg=NN.odg(di), di=di, movs=mov_vec,
                               total_signal_energy=torch.sum(rhalf ** 2),
                               total_noise_energy=torch.sum(nhalf ** 2))
