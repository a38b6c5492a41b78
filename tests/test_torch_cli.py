"""The port's front end against the JAX package's, on the CPU: the CLI
(cli.main in-process with GSTPEAQ_PLATFORM=cpu), WAV reading (wavio and the
native library), the conformance harness and the cognitive model's
training step.

Tolerances: the CLI's printed ODG, DI and SNR lines equal the JAX CLI's
byte for byte, and its MOVs (the PeaqResult behind --console-output) are
within 1e-9 (1 + |w|); WAV reads and resampling are bit for bit; the
conformance DIs within 1e-9; the training step's loss and parameters
within 1e-12 relative.
"""

import contextlib
import io
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from gstpeaq_tpu import cli as JCLI
from gstpeaq_tpu import conformance as JCF
from gstpeaq_tpu.models import nn as JNN
from gstpeaq_tpu.utils import native as JNATIVE
from gstpeaq_tpu.utils import wavio as JWAV
from gstpeaq_tpu_torch import cli as PCLI
from gstpeaq_tpu_torch import conformance as PCF
from gstpeaq_tpu_torch.models import nn as PNN
from gstpeaq_tpu_torch.utils import native as PNATIVE
from gstpeaq_tpu_torch.utils import testsignals as TS
from gstpeaq_tpu_torch.utils import wavio as PWAV

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 48 * 1024          # ~1 s: past the 25 frames the MOV gates need


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """saw / triangle, mono and stereo, and a 3-channel file, as float
    WAVs written by the port's wavio."""
    d = tmp_path_factory.mktemp("wavs")
    saw, tri = TS.saw(N), TS.triangle(N)
    files = {"ref": saw[:, None], "test": tri[:, None],
             "ref2": np.stack([saw, 0.5 * saw], 1),
             "test2": np.stack([tri, TS.sine(N, 660.0)], 1),
             "test3": np.stack([tri, tri, tri], 1)}
    out = {}
    for name, x in files.items():
        out[name] = str(d / f"{name}.wav")
        PWAV.write_wav(out[name], x)
    (d / "junk.wav").write_bytes(b"not a wav file")
    out["junk"] = str(d / "junk.wav")
    out["missing"] = str(d / "missing.wav")
    return out


def run_cli(module, argv, monkeypatch):
    """(exit code, stdout lines, the PeaqResult behind them or None)."""
    monkeypatch.setenv("GSTPEAQ_PLATFORM", "cpu")
    seen = []
    peaq = module.api.peaq

    def spy(*args, **kwargs):
        seen.append(peaq(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(module.api, "peaq", spy)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = module.main(argv)
    monkeypatch.setattr(module.api, "peaq", peaq)
    return rc, out.getvalue().splitlines(), (seen[0] if seen else None)


@pytest.mark.parametrize("flags,ref,test", [
    (["--console-output"], "ref", "test"),
    (["--advanced", "--console-output"], "ref", "test"),
    (["--totalsnr"], "ref2", "test2"),
    (["--bands", "55", "--console-output"], "ref", "test"),
    (["--advanced", "--totalsnr"], "ref", "test2"),       # mono upmix
    (["--console-output"], "ref2", "test"),               # mono upmix
])
def test_cli_matches_jax(wavs, monkeypatch, flags, ref, test):
    """float64, the default tier: the same lines, and the MOVs within
    1e-9 (1 + |w|)."""
    argv = flags + [wavs[ref], wavs[test]]
    rc, lines, res = run_cli(PCLI, argv, monkeypatch)
    jrc, jlines, jres = run_cli(JCLI, argv, monkeypatch)
    assert rc == jrc == 0
    assert len(lines) == len(jlines)
    for got, want in zip(lines, jlines):
        if got.startswith(("Objective", "Distortion", "Total SNR")):
            assert got == want
        else:
            assert got.rsplit(" ", 1)[0] == want.rsplit(" ", 1)[0]
    assert lines[-2 - ("--totalsnr" in flags)].startswith(
        "Objective Difference Grade: ")
    for name, w in jres.movs.items():
        assert abs(res.movs[name] - w) <= 1e-9 * (1 + abs(w)), name
    assert abs(res.odg - jres.odg) <= 1e-9


@pytest.mark.parametrize("advanced", [False, True])
def test_cli_mixed_near_jax(wavs, monkeypatch, advanced):
    """--precision mixed (float32 band chain): the same line format, ODG
    within 2e-3 and MOVs within 1e-3 (1 + |w|) of the JAX CLI's "mixed"
    (test_torch_tiers.py's bars)."""
    argv = (["--advanced"] * advanced + ["--precision", "mixed",
                                         "--console-output", wavs["ref"],
                                         wavs["test"]])
    rc, lines, res = run_cli(PCLI, argv, monkeypatch)
    jrc, jlines, jres = run_cli(JCLI, argv, monkeypatch)
    assert rc == jrc == 0
    assert [line.rsplit(" ", 1)[0] for line in lines] == [
        line.rsplit(" ", 1)[0] for line in jlines]
    assert abs(res.odg - jres.odg) <= 2e-3
    for name, w in jres.movs.items():
        assert abs(res.movs[name] - w) <= 1e-3 * (1 + abs(w)), name


def test_cli_upmix_equals_stereo_input(wavs, monkeypatch, tmp_path):
    """A mono ref against a stereo test is scored as the ref copied to
    both channels."""
    both = str(tmp_path / "both.wav")
    PWAV.write_wav(both, np.repeat(PWAV.read_wav(wavs["ref"])[0], 2, 1))
    _, mono, _ = run_cli(PCLI, [wavs["ref"], wavs["test2"]], monkeypatch)
    _, stereo, _ = run_cli(PCLI, [both, wavs["test2"]], monkeypatch)
    assert mono == stereo


@pytest.mark.parametrize("argv,code", [
    ([], 1),
    (["--basic", "--advanced", "ref", "test"], 1),
    (["ref2", "test3"], 1),
    (["missing", "test"], 2),
    (["ref", "junk"], 2),
])
def test_cli_exit_codes_match_jax(wavs, monkeypatch, argv, code):
    argv = [wavs.get(a, a) for a in argv]
    assert run_cli(PCLI, argv, monkeypatch)[0] == code
    assert run_cli(JCLI, argv, monkeypatch)[0] == code


def test_cli_without_cuda_fails(wavs, monkeypatch, capsys):
    """No GSTPEAQ_PLATFORM and no CUDA: exit 1 with a message, and no run
    on the CPU."""
    monkeypatch.delenv("GSTPEAQ_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(PCLI.api, "peaq", None)
    assert PCLI.main([wavs["ref"], wavs["test"]]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_module_version_subprocess():
    proc = subprocess.run([sys.executable, "-m", "gstpeaq_tpu_torch",
                           "--version"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "gstpeaq-tpu-torch 0.1.0"


# ---------------------------------------------------------------------------
# WAV I/O
# ---------------------------------------------------------------------------


def pcm_wav(path, payload: bytes, channels: int, rate: int, bits: int,
            audio_format: int = 1, extensible: bool = False):
    """A WAV file of raw `payload`; EXTENSIBLE carries the format in its
    sub-format GUID's first two bytes."""
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else audio_format,
                      channels, rate, rate * block, block, bits)
    if extensible:
        fmt += struct.pack("<HHIH14s", 22, bits, 0, audio_format, b"\0" * 14)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    pathlib.Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body))
                                   + body)
    return str(path)


def wav_cases(tmp_path):
    rng = np.random.default_rng(3)
    i16 = rng.integers(-32768, 32768, (3000, 2)).astype("<i2")
    i24 = rng.integers(0, 256, (3000 * 2 * 3,)).astype(np.uint8)
    i32 = rng.integers(-2**31, 2**31, (3000, 2)).astype("<i4")
    u8 = rng.integers(0, 256, (3000, 1)).astype(np.uint8)
    f32 = rng.uniform(-1, 1, (3000, 2)).astype("<f4")
    f64 = rng.uniform(-1, 1, (3000, 1)).astype("<f8")
    return {
        "pcm16": pcm_wav(tmp_path / "a.wav", i16.tobytes(), 2, 48000, 16),
        "pcm24": pcm_wav(tmp_path / "b.wav", i24.tobytes(), 2, 48000, 24),
        "pcm32": pcm_wav(tmp_path / "c.wav", i32.tobytes(), 2, 44100, 32),
        "pcm8": pcm_wav(tmp_path / "d.wav", u8.tobytes(), 1, 48000, 8),
        "float32": pcm_wav(tmp_path / "e.wav", f32.tobytes(), 2, 48000, 32,
                           3),
        "float64": pcm_wav(tmp_path / "f.wav", f64.tobytes(), 1, 48000, 64,
                           3),
        "ext16": pcm_wav(tmp_path / "g.wav", i16.tobytes(), 2, 44100, 16,
                         1, extensible=True),
        "ext_float": pcm_wav(tmp_path / "h.wav", f32.tobytes(), 2, 48000,
                             32, 3, extensible=True),
    }


def test_wav_reads_equal_jax(tmp_path):
    """read_wav, read_wav_pcm16_48k, load_audio_48k (44.1 kHz files
    resampled) and the native reader: the port's equal the JAX package's
    bit for bit on every format."""
    assert PNATIVE.available() == JNATIVE.available()
    for name, path in wav_cases(tmp_path).items():
        (x, rate), (jx, jrate) = PWAV.read_wav(path), JWAV.read_wav(path)
        assert rate == jrate and x.dtype == jx.dtype == np.float32, name
        np.testing.assert_array_equal(x, jx, err_msg=name)
        raw, jraw = (m.read_wav_pcm16_48k(path) for m in (PWAV, JWAV))
        assert (raw is None) == (jraw is None), name
        if raw is not None:
            np.testing.assert_array_equal(raw, jraw, err_msg=name)
        for port, jax_ in ((PWAV, JWAV), (PNATIVE, JNATIVE)):
            got, want = port.load_audio_48k(path), jax_.load_audio_48k(path)
            np.testing.assert_array_equal(got, want, err_msg=name)
        np.testing.assert_array_equal(PNATIVE.load_audio_48k_ship(path),
                                      JNATIVE.load_audio_48k_ship(path))
    with pytest.raises(ValueError):
        PWAV.read_wav(str(pcm_wav(tmp_path / "bad.wav", b"\0" * 12, 1,
                                  48000, 12)))


def test_resample_44k1_equals_jax(tmp_path):
    """44.1 kHz -> 48 kHz: scipy's polyphase path (wavio) and the native
    library's, the port's against the JAX package's, bit for bit; the tone
    stays at 1 kHz."""
    t = np.arange(44100) / 44100.0
    x = np.stack([np.sin(2 * np.pi * 1000.0 * t),
                  0.5 * np.sin(2 * np.pi * 3000.0 * t)], 1).astype(np.float32)
    y = PWAV.resample_to_48k(x, 44100)
    np.testing.assert_array_equal(y, JWAV.resample_to_48k(x, 44100))
    assert abs(y.shape[0] - 48000) <= 2
    path = str(tmp_path / "t44.wav")
    PWAV.write_wav(path, x, 44100)
    np.testing.assert_array_equal(PNATIVE.load_audio_48k(path),
                                  JNATIVE.load_audio_48k(path))
    mid = y[2000:40000, 0]
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    assert abs(np.argmax(spec) * 48000.0 / len(mid) - 1000.0) < 5.0


# ---------------------------------------------------------------------------
# Conformance harness
# ---------------------------------------------------------------------------


def fake_dataset(directory, items):
    """A synthetic two-item dataset under the ITU names (the real items
    are proprietary): a ref with content past 8.1 kHz and a dither floor,
    so that every MOV gate stays open, and a noisy test."""
    n = 48000 * 3 // 5
    rng = np.random.default_rng(0)
    t = np.arange(n) / 48000.0
    for i, item in enumerate(items):
        ref = (0.3 * np.sin(2 * np.pi * (440 + 100 * i) * t)
               + 0.1 * np.sin(2 * np.pi * 3500.0 * t)
               + 0.03 * np.sin(2 * np.pi * 9200.0 * t)
               + 2e-5 * rng.standard_normal(n))
        test = ref + 0.01 * rng.standard_normal(n)
        PWAV.write_wav(str(directory / (item.replace("cod", "ref") + ".wav")),
                       ref.astype(np.float32)[:, None])
        PWAV.write_wav(str(directory / (item + ".wav")),
                       test.astype(np.float32)[:, None])


@pytest.mark.parametrize("advanced", [False, True])
def test_conformance_run_matches_jax(tmp_path, monkeypatch, advanced):
    items = ["acodsna", "bcodtri"]
    fake_dataset(tmp_path, items)
    name = "CONFORMANCE_ADVANCED" if advanced else "CONFORMANCE_BASIC"
    for module in (PCF, JCF):
        monkeypatch.setattr(module, name,
                            {k: getattr(module, name)[k] for k in items})
    monkeypatch.setenv("GSTPEAQ_PLATFORM", "cpu")
    rows = PCF.run(advanced, directory=str(tmp_path), device="cpu")
    jrows = JCF.run(advanced, directory=str(tmp_path))
    assert [r.item for r in rows] == [r.item for r in jrows] == items
    for r, j in zip(rows, jrows):
        assert abs(r.di - j.di) < 1e-9 and abs(r.odg - j.odg) < 1e-9
        assert (r.itu_di, r.blessed_di, r.itu_odg) == (
            j.itu_di, j.blessed_di, j.itu_odg)
    assert PCF.report(rows) == JCF.report(jrows)
    assert PCF.stats(rows) == JCF.stats(jrows)
    assert PCF.xml_table(rows, advanced) == JCF.xml_table(jrows, advanced)
    # synthetic audio does not match the blessed DIs: main()'s gate fails
    assert max(abs(r.delta_blessed) for r in rows) >= 1e-3
    monkeypatch.setenv("CONFORMANCEDATADIR", str(tmp_path))
    argv = ["--advanced"] if advanced else []
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert PCF.main(argv) == 1
    assert "max |dBlessed|" in out.getvalue()


def test_conformance_without_dataset(monkeypatch, capsys):
    """No dataset: run raises FileNotFoundError, main exits 77."""
    monkeypatch.delenv("CONFORMANCEDATADIR", raising=False)
    with pytest.raises(FileNotFoundError):
        PCF.run(advanced=False, device="cpu")
    assert PCF.main([]) == 77
    assert "NOT run" in capsys.readouterr().out
    monkeypatch.setenv("CONFORMANCEDATADIR", os.devnull + "-absent")
    assert PCF.data_dir() is None


def test_conformance_table_strings_equal_jax():
    """xml_table and stats of the same rows, in both packages."""
    rows = [(i, d, o) for i, d, o in [("acodsna", 1.30, -0.68),
                                      ("bcodtri", 1.95, -0.30)]]
    for advanced in (False, True):
        got, want = ([m.ConformanceRow(item=i, di=d, odg=o, itu_di=d - 0.01,
                                       blessed_di=d, itu_odg=o + 0.02)
                      for i, d, o in rows] for m in (PCF, JCF))
        assert PCF.xml_table(got, advanced) == JCF.xml_table(want, advanced)
        assert PCF.stats(got) == JCF.stats(want)
        assert PCF.report(got) == JCF.report(want)


# ---------------------------------------------------------------------------
# The cognitive model's training step
# ---------------------------------------------------------------------------


def rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("advanced", [False, True])
def test_sgd_train_step_matches_jax(advanced):
    """Five SGD steps of the port's sgd_train_step against the JAX
    package's from the same standard weights: losses and parameters
    within 1e-12 relative; the forward and the loss too."""
    import jax
    rng = np.random.default_rng(11 + advanced)
    m = 5 if advanced else 11
    movs = rng.standard_normal((48, m)) * 10 + 50
    target = rng.standard_normal(48)
    params = PNN.init_cognitive_params(advanced)
    jparams = JNN.init_cognitive_params(advanced)
    assert all(p.requires_grad and p.dtype == torch.float64
               for p in params.values())
    tm, tt = torch.from_numpy(movs), torch.from_numpy(target)
    assert rel(PNN.cognitive_forward(params, tm).detach(),
               JNN.cognitive_forward(jparams, movs)) < 1e-12
    assert rel(PNN.cognitive_loss(params, tm, tt).detach(),
               JNN.cognitive_loss(jparams, movs, target)) < 1e-12
    step = jax.jit(JNN.sgd_train_step, static_argnames="lr")
    for _ in range(5):
        params, loss = PNN.sgd_train_step(params, tm, tt, 1e-3)
        jparams, jloss = step(jparams, movs, target, lr=1e-3)
        assert rel(loss, jloss) < 1e-12
    for name, p in params.items():
        assert rel(p.detach(), jparams[name]) < 1e-12, name
