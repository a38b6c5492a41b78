"""The port's user tools (gstpeaq_tpu_torch/tools/codec_sweep.py,
longform_bench.py, optimize_settings.py) against the JAX package's
(tools/*.py), on the CPU with GSTPEAQ_PLATFORM=cpu, float64.

Tolerances: the sweep's TSV equals, string for string, the lines that the
JAX package's peaq_batch gives on the same loaded pairs; the long-form
tool's final line equals the JAX tool's, run in a subprocess under
JAX_ENABLE_X64=1; its feeds equal the JAX tool's loop array for array; the
settings sweep prints the JAX tool's lines.
"""

import contextlib
import importlib.util
import io
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gstpeaq_tpu import conformance as JCF
from gstpeaq_tpu.parallel import batch as JB
from gstpeaq_tpu.utils import native as JNATIVE
from gstpeaq_tpu_torch import conformance as PCF
from gstpeaq_tpu_torch.tools import codec_sweep as PSWEEP
from gstpeaq_tpu_torch.tools import longform_bench as PLONG
from gstpeaq_tpu_torch.tools import optimize_settings as POPT
from gstpeaq_tpu_torch.utils import wavio as PWAV
from gstpeaq_tpu_torch.parallel.batch import to_pcm16
from gstpeaq_tpu_torch.utils.benchpairs import make_pairs
from test_torch_cli import fake_dataset, pcm_wav

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_CONFIG = ("jax_platforms", "jax_enable_x64", "jax_compilation_cache_dir")
# one intra-op thread for the port, here and in the subprocesses: beside
# the other test workers, more threads than cores make torch's small CPU
# ops wait on each other (a 12 s run took over 600 s)
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool(name: str):
    """tools/<name>.py loaded by its path (tools/ is not a package), with
    sys.path restored after its import.  The tool puts a fixed directory
    ahead on sys.path; the JAX package it uses must still be this
    checkout's, imported above."""
    path = sys.path[:]
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    assert pathlib.Path(sys.modules["gstpeaq_tpu"].__file__).is_relative_to(
        ROOT)
    return module


def run_main(main, argv, monkeypatch):
    """(exit code, stdout, stderr) of main(argv) on the CPU."""
    monkeypatch.setenv("GSTPEAQ_PLATFORM", "cpu")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# codec_sweep
# ---------------------------------------------------------------------------


def test_load_manifest_matches_jax(tmp_path):
    """The same pairs from comments, blank lines, extra columns and
    surrounding spaces; importing the JAX tool touches no JAX setting."""
    before = {k: getattr(jax.config, k) for k in JAX_CONFIG}
    jtool = jax_tool("codec_sweep")
    assert {k: getattr(jax.config, k) for k in JAX_CONFIG} == before
    path = tmp_path / "manifest.tsv"
    path.write_text("# ref\ttest\n\nr1.wav\tt1.wav\n   \n"
                    "  r2.wav\tt2.wav\textra\n#r3.wav\tt3.wav\n"
                    "r4.wav\tt 4.wav  \n")
    got = PSWEEP.load_manifest(str(path))
    assert got == jtool.load_manifest(str(path))
    assert got == [("r1.wav", "t1.wav"), ("r2.wav", "t2.wav"),
                   ("r4.wav", "t 4.wav")]


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """Three 2 s stereo pairs: PCM16 at 48 kHz, float32 at 48 kHz and
    PCM16 at 44.1 kHz (resampled on loading)."""
    d = tmp_path_factory.mktemp("sweep")
    refs, tests = make_pairs(3, 2.0)
    lines = []
    for i, (kind, rate) in enumerate([("pcm16", 48000), ("float", 48000),
                                      ("pcm16", 44100)]):
        paths = []
        for sig, x in (("ref", refs[i]), ("test", tests[i])):
            path = d / f"{sig}{i}.wav"
            if kind == "pcm16":
                pcm_wav(path, to_pcm16(x).astype("<i2").tobytes(),
                        x.shape[1], rate, 16)
            else:
                PWAV.write_wav(str(path), x, rate)
            paths.append(str(path))
        lines.append("\t".join(paths))
    path = d / "manifest.tsv"
    path.write_text("# three pairs\n" + "\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("advanced", [False, True])
@pytest.mark.parametrize("pcm16", [False, True])
def test_codec_sweep_matches_jax_peaq_batch(manifest, tmp_path, monkeypatch,
                                            advanced, pcm16):
    """The port tool's TSV against the JAX package's peaq_batch on the
    pairs as tools/codec_sweep.py loads them (the native loader, the PCM16
    ship and the quantization of float sources under --pcm16), formatted
    as that tool formats them, string for string."""
    out = tmp_path / "out.tsv"
    argv = [manifest, "--out", str(out)] + ["--advanced"] * advanced \
        + ["--pcm16"] * pcm16
    rc, stdout, stderr = run_main(PSWEEP.main, argv, monkeypatch)
    assert rc == 0 and stdout == ""
    lines = stderr.splitlines()
    assert re.fullmatch(r"# 3 pairs, 6 audio-sec in \S+s \(\d+ audio-sec/s\)"
                        r", peak host RSS \S+ GB", lines[0]), lines
    assert re.fullmatch(r"# phases: stage \S+s dispatch \S+s first_sync \S+s"
                        r" drain \S+s; excl\. one-time program-load stall: "
                        r"\d+ audio-sec/s", lines[1]), lines

    pairs = jax_tool("codec_sweep").load_manifest(manifest)
    load = (JNATIVE.load_audio_48k_ship if pcm16
            else JNATIVE.load_audio_48k)
    refs = [load(r) for r, _ in pairs]
    tests = [load(t) for _, t in pairs]
    if pcm16:
        q = lambda x: x if x.dtype == np.int16 else np.clip(  # noqa: E731
            np.round(np.asarray(x, np.float64) * 32768.0),
            -32768, 32767).astype(np.int16)
        refs = [q(r) for r in refs]
        tests = [q(t) for t in tests]
        assert [r.dtype for r in refs] == [np.int16] * 3
    want = JB.peaq_batch(refs, tests, advanced=advanced, microbatch=32,
                         prefetch_gb=6.0)
    text = "item\todg\tdi\n" + "\n".join(
        f"{t}\t{o:.4f}\t{d:.4f}"
        for (_, t), o, d in zip(pairs, want["odg"], want["di"])) + "\n"
    assert out.read_text() == text


def test_codec_sweep_demo_to_stdout(monkeypatch):
    """--demo N scores make_pairs(N, 10.0) to stdout, one row per pair."""
    rc, stdout, _ = run_main(PSWEEP.main, ["--demo", "2", "--pcm16"],
                             monkeypatch)
    assert rc == 0
    rows = stdout.splitlines()
    assert rows[0] == "item\todg\tdi"
    assert [r.split("\t")[0] for r in rows[1:]] == ["demo0", "demo1"]
    assert all(np.isfinite(float(v)) for r in rows[1:]
               for v in r.split("\t")[1:])


# ---------------------------------------------------------------------------
# longform_bench
# ---------------------------------------------------------------------------


def jax_feeds(ref_b, test_b, total, ns, pcm16):
    """tools/longform_bench.py's feed loop (:161-177), its feeds yielded."""
    feed = 48000 * 10
    base_n = 48000 * 30
    rng = np.random.default_rng(0)
    done = 0
    while done < total:
        n = min(feed, total - done)
        off = done % base_n          # feed divides base_n: no wrap
        ref1 = ref_b[off:off + n]
        test1 = test_b[off:off + n] + (1e-4 * rng.standard_normal(n)
                                       ).astype(np.float32)
        if ns > 1:
            # [N, T, CH]: same program per stream, distinct noise floors
            noise = (1e-4 * rng.standard_normal((ns - 1, n))
                     ).astype(np.float32)
            tests1 = np.concatenate(
                [test1[None], test_b[off:off + n][None] + noise])
            ref = np.broadcast_to(ref1[None, :, None], (ns, n, 2))
            test = np.repeat(tests1[:, :, None], 2, axis=2)
        else:
            ref = np.stack([ref1, ref1], 1)
            test = np.stack([test1, test1], 1)
        if pcm16:
            q = lambda x: np.clip(  # noqa: E731
                np.round(x.astype(np.float64) * 32768.0),
                -32768, 32767).astype(np.int16)
            ref, test = q(ref), q(test)
        yield ref, test
        done += n


@pytest.mark.parametrize("ns,pcm16", [(1, False), (3, False), (1, True)])
def test_longform_feeds_match_jax_loop(ns, pcm16):
    """The first two feeds of the program (and a short last one) equal
    the JAX tool's loop array for array, dtype and shape included."""
    ref_b, test_b = PLONG.base_program()
    assert ref_b.shape == test_b.shape == (48000 * 30,)
    assert ref_b.dtype == test_b.dtype == np.float32
    total = 2 * PLONG.FEED + 4800
    got = list(PLONG.feeds(ref_b, test_b, total, ns, pcm16))
    want = list(jax_feeds(ref_b, test_b, total, ns, pcm16))
    assert len(got) == len(want) == 3
    for (r, t), (jr, jt) in zip(got, want):
        for x, y in ((r, jr), (t, jt)):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def start_longform(args, tmp_path, jax_side: bool) -> subprocess.Popen:
    """The port's or the JAX tool as a subprocess on the CPU in float64
    (JAX's compilation cache under tmp_path).  The JAX tool puts a fixed
    directory ahead on sys.path, so the JAX package is imported from this
    checkout before the tool runs."""
    env = dict(os.environ, GSTPEAQ_PLATFORM="cpu", JAX_ENABLE_X64="1",
               PYTHONPATH=str(ROOT), **ONE_THREAD)
    if jax_side:
        tool = str(ROOT / "tools" / "longform_bench.py")
        code = ("import pathlib, runpy, sys\n"
                "import jax\n"
                "update = jax.config.update\n"
                "jax.config.update = lambda k, v: update(k, "
                f"{str(tmp_path / 'jax_cache')!r} "
                "if k == 'jax_compilation_cache_dir' else v)\n"
                "import gstpeaq_tpu, gstpeaq_tpu.parallel.stream\n"
                "assert pathlib.Path(gstpeaq_tpu.__file__).is_relative_to("
                f"{str(ROOT)!r}), gstpeaq_tpu.__file__\n"
                f"sys.argv = [{tool!r}, *{args!r}]\n"
                f"runpy.run_path({tool!r}, run_name='__main__')\n")
        cmd = [sys.executable, "-c", code]
    else:
        cmd = [sys.executable,
               str(ROOT / "gstpeaq_tpu_torch" / "tools" / "longform_bench.py"),
               *args]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=env)


def stdout_lines(proc: subprocess.Popen) -> list[str]:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return out.splitlines()


@pytest.mark.parametrize("args", [
    ["--minutes", "0.5", "--chunk", "16"],
    ["--minutes", "0.5", "--chunk", "16", "--advanced", "--streams", "2"],
])
def test_longform_final_line_matches_jax(tmp_path, args):
    """The final line (ODG and DI, or the pool's median, min and max) is
    the JAX tool's; the rate line has the JAX tool's form.  The two run
    side by side."""
    procs = [start_longform(args, tmp_path, jax_side) for jax_side in
             (False, True)]
    try:
        got, want = (stdout_lines(proc) for proc in procs)
    finally:
        for proc in procs:
            proc.kill()
    assert got[-1] == want[-1]
    streams = "2 streams" if "--streams" in args else "1 stream"
    for lines in (got, want):
        assert len(lines) == 2
        assert re.fullmatch(
            r"processed (30|60) audio-sec in \S+s \(\S+x realtime aggregate "
            rf"= \d+ audio-sec/s, {streams}\)", lines[0]), lines


@pytest.mark.parametrize("advanced", [False, True])
def test_longform_device_source_runs(monkeypatch, advanced):
    """--device-source drives a pool's chunk steps on one staged chunk
    pair and prints its rate line; without a pool it exits 1."""
    argv = ["--device-source", "--streams", "2", "--minutes", "0.2",
            "--chunk", "16"] + ["--advanced"] * advanced
    rc, stdout, _ = run_main(PLONG.main, argv, monkeypatch)
    assert rc == 0
    assert re.fullmatch(r"device-source: \d+ audio-sec in \S+s \(\d+ "
                        r"audio-sec/s aggregate, 2 streams, carried state, "
                        r"transfers excluded\)\n", stdout), stdout
    with pytest.raises(SystemExit, match="needs --streams>1"):
        run_main(PLONG.main, argv[3:] + ["--device-source"], monkeypatch)


def test_longform_observe_sees_every_feed(monkeypatch):
    """observe(done, stream) follows each feed, and after the run the
    stream's current() is its finalized result."""
    seen = []
    rc, stdout, _ = run_main(
        lambda argv: PLONG.main(argv, observe=lambda done, s:
                                seen.append((done, s))),
        ["--minutes", "0.3", "--chunk", "16"], monkeypatch)
    assert rc == 0
    assert [done for done, _ in seen] == [480000, 864000]
    res = seen[-1][1].current()
    assert stdout.splitlines()[-1] == f"ODG {res.odg:.3f}  DI {res.di:.3f}"


@pytest.mark.parametrize("advanced", [False, True])
def test_chunk_steps_carry_no_views(advanced):
    """After chunk steps every state leaf owns its storage: no leaf is a
    view that keeps a chunk tensor alive (at the tool's 1,024-frame chunks
    those were ~0.5 GB a float64 stream)."""
    from gstpeaq_tpu_torch.utils.checkpoint import tree_flatten
    cls = PLONG.PeaqStreamAdvanced if advanced else PLONG.PeaqStream
    stream = cls(chunk_frames=16, device="cpu")
    ref, test = next(PLONG.feeds(*PLONG.base_program(), 3 * 16 * 3072))
    stream.feed(ref, test)
    leaves = tree_flatten(stream.state)
    assert leaves
    for leaf in leaves:
        assert leaf.untyped_storage().nbytes() <= \
            leaf.numel() * leaf.element_size(), tuple(leaf.shape)


# ---------------------------------------------------------------------------
# optimize_settings
# ---------------------------------------------------------------------------


def test_optimize_settings_matches_jax(tmp_path, monkeypatch):
    """Two flags (4 combinations) over the two-item dataset: the port
    tool's lines are the JAX tool's."""
    items = ["acodsna", "bcodtri"]
    fake_dataset(tmp_path, items)
    for module in (PCF, JCF):
        monkeypatch.setattr(module, "CONFORMANCE_BASIC",
                            {k: module.CONFORMANCE_BASIC[k] for k in items})
    jtool = jax_tool("optimize_settings")
    flags = ["center_ehs_correlation_window", "clamp_movs"]
    monkeypatch.setattr(POPT, "FLAGS", flags)
    monkeypatch.setattr(jtool, "FLAGS", flags)
    monkeypatch.setenv("CONFORMANCEDATADIR", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["optimize_settings.py"])
    rc, got, _ = run_main(POPT.main, [], monkeypatch)
    jrc, want, _ = run_main(lambda argv: jtool.main(), [], monkeypatch)
    assert rc == jrc == 0
    assert got == want
    lines = got.splitlines()
    assert [line[:2] for line in lines[:4]] == ["00", "01", "10", "11"]
    assert lines[-1].startswith("best: {'center_ehs_correlation_window': ")


def test_optimize_settings_without_dataset(monkeypatch):
    """Exit 77 without CONFORMANCEDATADIR, in both tools."""
    monkeypatch.delenv("CONFORMANCEDATADIR", raising=False)
    monkeypatch.setattr(sys, "argv", ["optimize_settings.py"])
    jtool = jax_tool("optimize_settings")
    for main in (POPT.main, lambda argv: jtool.main()):
        rc, out, _ = run_main(main, [], monkeypatch)
        assert rc == 77 and out == "CONFORMANCEDATADIR not set, sweep NOT " \
            "run.\n"


# ---------------------------------------------------------------------------
# No CUDA, no fallback
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tool,argv", [
    (PSWEEP, ["--demo", "1"]),
    (PLONG, ["--minutes", "0.1"]),
    (POPT, []),
], ids=["codec_sweep", "longform_bench", "optimize_settings"])
def test_tool_without_cuda_fails(tool, argv, tmp_path, monkeypatch, capsys):
    """No GSTPEAQ_PLATFORM and no CUDA: exit 1 with a message, before any
    work on the CPU."""
    monkeypatch.delenv("GSTPEAQ_PLATFORM", raising=False)
    monkeypatch.setenv("CONFORMANCEDATADIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 1
    name = tool.__name__.rsplit(".", 1)[1]
    assert f"{name}: CUDA is not available" in capsys.readouterr().err
