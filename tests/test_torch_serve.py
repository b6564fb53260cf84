"""The port's serving entry points (``megatts2_tpu_torch/serve.py``,
``megatts2_tpu_torch/infer.py``) end to end on the CPU (``--device cpu``),
on tiny checkpoints the port writes into ``tmp_path`` in the reference
layout and reads back through ``megatts_from_pretrained``: the batch,
continuous and HTTP modes (wav count and lengths, the JSON line, 400, 413
and 504), the prompt resolver's dedupe under concurrency (as
``tests/test_cli.py`` holds JAX's), ``pick_bucket`` and ``infer.main``."""
import dataclasses
import io
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from test_torch_streaming import build_cascade

TEXTS = ["hello world", "nice day hello", "world", "hello nice day world hello", "day"]


def _yaml(d: dict, indent: int = 0) -> str:
    """A nested dict of scalars and tuples as block YAML (the port's subset)."""
    out = ""
    for k, v in d.items():
        pad = " " * indent
        if isinstance(v, dict):
            out += f"{pad}{k}:\n" + _yaml(v, indent + 2)
        elif isinstance(v, (tuple, list)):
            out += f"{pad}{k}: {json.dumps(v)}\n"
        else:
            out += f"{pad}{k}: {str(v).lower() if isinstance(v, bool) else v}\n"
    return out


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if not dataclasses.is_dataclass(getattr(cfg, f.name))}


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """Tiny configs, the port's checkpoints, two prompt dirs, a symbol
    table and a stage-2 prompt dataset."""
    from megatts2_tpu_torch.data import Cut, CutManifest
    from megatts2_tpu_torch.training.checkpoints import model_state_dict
    from megatts2_tpu_torch.utils.audio import save_wav

    root = tmp_path_factory.mktemp("torch_serve")
    c = build_cascade()
    g_cfg, plm_cfg, adm_cfg, hifi_cfg = c["tcfgs"]
    g, plm, adm, hifi = c["port"]()
    paths = {}
    gan = {"model": {"G": {"mrte": _fields(g_cfg.mrte), "vqpe": _fields(g_cfg.vqpe),
                           **_fields(g_cfg)}}}
    for name, text in (("gan", _yaml(gan)),
                       ("plm", _yaml({"model": {"plm": _fields(plm_cfg)}})),
                       ("adm", _yaml({"model": {"adm": _fields(adm_cfg)}})),
                       ("voc", _yaml({"model": {"vocoder": {
                           "family": "hifigan", "init_args": _fields(hifi_cfg)}}}))):
        paths[name] = str(root / f"{name}.yaml")
        open(paths[name], "w").write(text)
    for name, module in (("g_ck", g), ("plm_ck", plm), ("adm_ck", adm), ("hifi_ck", hifi)):
        paths[name] = str(root / f"{name}.ckpt")
        torch.save({"state_dict": model_state_dict(module)}, paths[name])
    paths["sym"] = str(root / "sym")
    with open(paths["sym"], "w") as f:
        for i, s in enumerate(["<eps>", "_", "hello", "world", "nice", "day"]):
            f.write(f"{s} {i}\n")
    for name, (n, hz) in (("pa", (4000, 250)), ("pb", (5200, 180))):
        d = root / name
        d.mkdir()
        t = np.arange(n) / 16000
        save_wav(str(d / "p.wav"), (0.2 * np.sin(2 * np.pi * hz * t)).astype(np.float32))
        paths[name] = str(d)
    ds = root / "prompt_ds"
    (ds / "latents" / "spkA").mkdir(parents=True)
    rng = np.random.RandomState(7)
    durs = [2, 3, 1, 2, 4, 4]
    cut = Cut(id="c0", speaker="spkA", duration=1.0, num_frames=sum(durs),
              phone_tokens=["hello"] * len(durs), duration_tokens=durs)
    CutManifest([cut]).save(str(ds / "cuts_train.jsonl.gz"))
    np.save(str(ds / "latents" / "spkA" / "c0.npy"),
            {"tc_latent": rng.randn(1, len(durs), 16).astype(np.float32),
             "p_code": rng.randint(0, 32, (1, 1, 2)).astype(np.int32)}, allow_pickle=True)
    paths["prompt_ds"] = str(ds)
    reqs = root / "reqs.jsonl"
    with open(reqs, "w") as f:
        for i, t in enumerate(TEXTS):
            f.write(json.dumps({"id": f"u{i}", "text": t,
                                "wavs_dir": paths["pa" if i % 2 else "pb"]}) + "\n")
    paths["reqs"] = str(reqs)
    return paths


def _common(fx):
    return ["--g_ckpt", fx["g_ck"], "--g_config", fx["gan"], "--plm_ckpt", fx["plm_ck"],
            "--plm_config", fx["plm"], "--adm_ckpt", fx["adm_ck"], "--adm_config", fx["adm"],
            "--hifigan_ckpt", fx["hifi_ck"], "--vocoder_config", fx["voc"],
            "--symbol_table", fx["sym"], "--device", "cpu", "--max_frames", "96"]


def test_pick_bucket():
    from megatts2_tpu.serve import pick_bucket as jpick
    from megatts2_tpu_torch.serve import pick_bucket

    for n in (0, 1, 15, 16, 17, 40, 64, 65, 200):
        assert pick_bucket(n, 4.0, [64, 128, 256]) == jpick(n, 4.0, [64, 128, 256])
    assert pick_bucket(16, 4.0, [64, 128]) == 64
    assert pick_bucket(17, 4.0, [64, 128]) == 128
    assert pick_bucket(1000, 4.0, [64, 128]) == 128


def test_parse_args_keeps_the_jax_flags_and_defaults():
    from megatts2_tpu.serve import parse_args as jparse
    from megatts2_tpu_torch.serve import parse_args

    got, want = vars(parse_args([])), vars(jparse([]))
    assert {k: got[k] for k in want} == want
    assert got["device"] == "cuda"


def _wavs(out):
    return {n[:-4]: wavfile.read(os.path.join(out, n)) for n in sorted(os.listdir(out))}


@pytest.mark.parametrize("mode", ["batch", "continuous", "continuous_prompted"])
def test_serve_modes_write_every_wav(fx, tmp_path, capsys, mode):
    from megatts2_tpu_torch.serve import main

    out = str(tmp_path / "out")
    extra = {"batch": ["--batch_size", "2", "--buckets", "32,64", "--frames_per_phone", "8"],
             "continuous": ["--continuous", "--slots", "2", "--chunk_frames", "32"],
             "continuous_prompted": ["--continuous", "--slots", "2", "--chunk_frames", "32",
                                     "--prompt_ds", fx["prompt_ds"], "--prompt_tokens", "16"]}
    reqs = fx["reqs"]
    if mode == "continuous_prompted":
        reqs = str(tmp_path / "reqs.jsonl")
        with open(fx["reqs"]) as f, open(reqs, "w") as g:
            for i, line in enumerate(f):
                r = json.loads(line)
                if i % 2 == 0:
                    r["prompt_speaker"] = "spkA"
                g.write(json.dumps(r) + "\n")
    record = main(["--requests", reqs, "--out_dir", out] + _common(fx) + extra[mode])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == record and line["device"] == "cpu"
    assert line["requests"] == len(TEXTS) and line["audio_s"] > 0 and line["rtf"] > 0
    assert line["mode"] == mode.split("_")[0]
    wavs = _wavs(out)
    assert sorted(wavs) == [f"u{i}" for i in range(len(TEXTS))]
    for sr, w in wavs.values():
        assert sr == 16000 and w.size > 0 and w.size % 256 == 0 and np.isfinite(w).all()


def test_serve_batch_on_two_ranks_writes_what_one_process_writes(fx, tmp_path):
    """``serve`` under a group of 2 ranks (gloo, CPU): each batch split over
    the data axis after its padding, rank 0 writes every wav under the same
    names as one process, equal to within one int16 step (fp32 sums of a
    batch of 1 against one of 2)."""
    import parallel_workers as pw
    from megatts2_tpu_torch.serve import main

    extra = ["--batch_size", "2", "--buckets", "32,64", "--frames_per_phone", "8"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    main(["--requests", fx["reqs"], "--out_dir", one] + _common(fx) + extra)
    out = pw.run(2, [("serve_batch", {"argv": ["--requests", fx["reqs"], "--out_dir", two]
                                      + _common(fx) + extra})], str(tmp_path))
    assert out["serve_batch"] is None, out["serve_batch"]
    want, got = _wavs(one), _wavs(two)
    assert sorted(got) == sorted(want) == [f"u{i}" for i in range(len(TEXTS))]
    for name, (sr, w) in want.items():
        assert got[name][0] == sr and got[name][1].shape == w.shape, name
        np.testing.assert_allclose(got[name][1], w, rtol=0, atol=1, err_msg=name)


def test_serve_requires_checkpoints_and_a_manifest(fx):
    from megatts2_tpu_torch.serve import main

    with pytest.raises(SystemExit, match="g_ckpt"):
        main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="requests"):
        main(_common(fx))


def _http(fx, drive, extra=()):
    """Run ``serve.main --http 0`` with ``drive(port)`` as the ready hook."""
    import megatts2_tpu_torch.serve as serve_mod

    out = {}

    def ready(server):
        try:
            out["result"] = drive(server.server_address[1])
        except BaseException as e:  # surfaced below
            out["error"] = e
        finally:
            server.shutdown()

    orig = serve_mod.run_http
    serve_mod.run_http = lambda args, tts: orig(args, tts, _ready_cb=ready)
    try:
        serve_mod.main(["--http", "0", "--slots", "2", "--chunk_frames", "32"] + _common(fx)
                       + list(extra))
    finally:
        serve_mod.run_http = orig
    if "error" in out:
        raise out["error"]
    return out["result"]


def _post(port, body: bytes, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _code(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_http_serves_concurrent_requests_and_refuses_bad_ones(fx):
    def drive(port):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert r.status == 200 and r.read() == b"ok"
        bodies = [json.dumps({"text": t, "wavs_dir": fx["pa" if i % 2 else "pb"]}).encode()
                  for i, t in enumerate(TEXTS[:4])]
        bodies.append(json.dumps({"text": "hello", "wavs_dir": fx["pa"],
                                  "prompt_cuts": ["c0"]}).encode())
        with ThreadPoolExecutor(5) as ex:
            got = list(ex.map(lambda b: _post(port, b), bodies))
        codes = [_code(lambda: _post(port, b"x" * ((1 << 20) + 1))),
                 _code(lambda: _post(port, b"not json")),
                 _code(lambda: _post(port, json.dumps({"text": "hello"}).encode())),
                 _code(lambda: _post(port, json.dumps({"text": "", "wavs_dir": fx["pa"]}).encode()))]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            metrics = json.loads(r.read())
        return got, codes, metrics

    got, codes, metrics = _http(fx, drive, ["--prompt_ds", fx["prompt_ds"],
                                            "--prompt_tokens", "16"])
    assert codes == [413, 400, 400, 400]
    for status, ctype, payload in got:
        sr, w = wavfile.read(io.BytesIO(payload))
        assert status == 200 and ctype == "audio/wav" and sr == 16000
        assert w.size > 0 and w.size % 256 == 0
    assert metrics["served"] == 5 and metrics["in_flight"] == 0 and metrics["engine_ticks"] > 0
    eng = metrics["engine"]  # the server's tally of its engine and prefill spans
    assert eng["engine.tick"]["count"] == metrics["engine_ticks"]
    assert eng["engine.queue_wait"]["count"] == eng["engine.first_chunk"]["count"] == 5
    assert set(eng) >= {"engine.admit", "engine.tick", "engine.emit"}
    assert eng["plm.prefill"]["count"] >= 1  # the prompted request's wave
    assert all(k.startswith("engine.") for k in set(eng) - {"plm.prefill"})
    for s in eng.values():
        assert set(s) == {"count", "mean_ms", "p50_ms", "p95_ms"}
        assert 0 <= s["p50_ms"] <= s["p95_ms"]


def test_http_times_out_with_504(fx):
    def drive(port):
        return _code(lambda: _post(port, json.dumps({"text": TEXTS[3],
                                                     "wavs_dir": fx["pa"]}).encode()))

    assert _http(fx, drive, ["--request_timeout", "0.001"]) == 504


def _resolver(monkeypatch, stub):
    import megatts2_tpu_torch.data as data_mod
    from megatts2_tpu_torch.serve import make_prompt_resolver

    monkeypatch.setattr(data_mod, "load_prompt_manifest", lambda ds: None)
    monkeypatch.setattr(data_mod, "resolve_prompt", stub)
    return make_prompt_resolver(types.SimpleNamespace(prompt_ds="x", prompt_n=2))


def test_resolver_dedupes_concurrent_requests_for_one_key(monkeypatch):
    calls, mu = [], threading.Lock()

    def stub(ds, cut_ids=None, speaker=None, n=0, manifest=None):
        with mu:
            calls.append(speaker)
        time.sleep(0.05)
        return np.zeros((4, 8), np.float32), np.zeros((4,), np.int32)

    resolver = _resolver(monkeypatch, stub)
    errs = []

    def worker():
        try:
            assert resolver({"prompt_speaker": "spkA"})[0].shape == (4, 8)
        except Exception as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert not errs and calls == ["spkA"]


def test_resolver_cache_hit_is_not_blocked_by_a_slow_resolve(monkeypatch):
    release, slow_started, ordered = threading.Event(), threading.Event(), []

    def stub(ds, cut_ids=None, speaker=None, n=0, manifest=None):
        if speaker == "slow":
            slow_started.set()
            ordered.append(release.wait(timeout=30.0))
        return np.zeros((2, 4), np.float32), np.zeros((2,), np.int32)

    resolver = _resolver(monkeypatch, stub)
    resolver({"prompt_speaker": "fast"})
    t = threading.Thread(target=resolver, args=({"prompt_speaker": "slow"},))
    t.start()
    assert slow_started.wait(timeout=30.0)
    out = resolver({"prompt_speaker": "fast"})
    release.set()
    t.join()
    assert out[0].shape == (2, 4) and ordered == [True]


def test_resolver_without_prompt_ds_refuses_prompts():
    from megatts2_tpu_torch.serve import make_prompt_resolver

    resolver = make_prompt_resolver(types.SimpleNamespace(prompt_ds=None))
    assert resolver({"text": "x"}) is None
    with pytest.raises(ValueError, match="prompt_ds"):
        resolver({"prompt_speaker": "spkA"})


def test_infer_main_writes_its_wav(fx, tmp_path):
    from megatts2_tpu_torch.infer import main

    out = str(tmp_path / "o.wav")
    wav = main(["--wavs_dir", fx["pa"], "--text", "hello world", "--out", out,
                "--plm_prompt_ds", fx["prompt_ds"], "--plm_prompt_speaker", "spkA"]
               + _common(fx))
    sr, data = wavfile.read(out)
    assert sr == 16000 and data.shape[0] == wav.shape[0] > 4000
    assert (wav.shape[0] - 4000) % 256 == 0


def test_infer_main_random_init_and_orbax_refusal(fx, tmp_path):
    from megatts2_tpu_torch.infer import main

    out = str(tmp_path / "r.wav")
    main(["--wavs_dir", fx["pa"], "--text", "hello", "--out", out, "--g_config", fx["gan"],
          "--plm_config", fx["plm"], "--adm_config", fx["adm"], "--vocoder_config", fx["voc"],
          "--symbol_table", fx["sym"], "--device", "cpu", "--max_frames", "64"])
    assert wavfile.read(out)[1].size > 4000
    with pytest.raises(ValueError, match="only torch checkpoints"):
        main(["--wavs_dir", fx["pa"], "--text", "hello", "--g_ckpt", str(tmp_path),
              "--g_config", fx["gan"], "--device", "cpu"])
