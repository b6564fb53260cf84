"""The port's data pipeline against the JAX package's, on the CPU.

Features: each package reads the other's shards exactly.  The sampler's
batch plan equals JAX's index for index over 3 epochs.  The GAN (native
reader on and off, one shard and two), PLM, ADM and vocoder batch builders
give JAX's batches bit for bit on one manifest and seed (tolerance 0: the
same numpy draws and arithmetic).  The native reader, built from the
port's copy of the source, equals JAX's native reader and the numpy read
exactly (fp16 → fp32 is exact): padding, ``concat_slices``' cut, an
out-of-range read refused, the ring with two tickets outstanding; a source
that does not compile raises instead of falling back.
"""
import os

import numpy as np
import pytest

from megatts2_tpu import data as jdata
from megatts2_tpu.data import native_loader as jnative
from megatts2_tpu.data.shape_guard import safe_target_frames
from megatts2_tpu_torch import data as tdata
from megatts2_tpu_torch.data import native_loader as tnative
from megatts2_tpu_torch.utils.audio import save_wav

N_SYM = 12
SYMBOLS = ["<eps>"] + [f"p{i:02d}" for i in range(N_SYM)]
TC_DIM, VQ_BINS = 16, 32


def _cuts(module, rng, shard, n, split, ds):
    """n cuts of 2 speakers, mels written to ``shard`` with ``module``'s writer."""
    cuts = []
    with module.FeatureWriter(shard, dim=80) as w:
        for i in range(n):
            frames = int(rng.randint(60, 190))
            path, off = w.add(rng.randn(frames, 80).astype(np.float32))
            n_ph = int(rng.randint(5, 14))
            durs = rng.randint(1, 2 * frames // n_ph, n_ph).tolist()  # Σ sometimes > frames
            spk = f"spk{i % 2}"
            cid = f"{split}{i}"
            wav = os.path.join(ds, f"{cid}.wav")
            save_wav(wav, 0.3 * rng.randn(int(rng.randint(1000, 5000))).astype(np.float32))
            cuts.append(dict(id=cid, speaker=spk, duration=frames * 256 / 16000, num_frames=frames,
                             phone_tokens=[SYMBOLS[1 + j] for j in rng.randint(N_SYM, size=n_ph)],
                             duration_tokens=durs, feats_path=path, feats_offset=off,
                             wav_path=wav))
            os.makedirs(os.path.join(ds, "latents", spk), exist_ok=True)
            np.save(os.path.join(ds, "latents", spk, f"{cid}.npy"),
                    {"tc_latent": rng.randn(1, n_ph, TC_DIM).astype(np.float32),
                     "p_code": rng.randint(0, VQ_BINS, (1, 1, -(-sum(durs) // 8))).astype(np.int32)})
    return cuts


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    """A dataset: train mels in a shard the JAX writer wrote, valid mels in
    one the port's wrote, symbols, latents and wavs."""
    root = str(tmp_path_factory.mktemp("ds"))
    rng = np.random.RandomState(0)
    train = _cuts(jdata, rng, os.path.join(root, "feats_train.bin"), 10, "train", root)
    valid = _cuts(tdata, rng, os.path.join(root, "feats_valid.bin"), 4, "valid", root)
    with open(os.path.join(root, "unique_text_tokens.k2symbols"), "w") as f:
        f.writelines(f"{s} {i}\n" for i, s in enumerate(SYMBOLS))
    return root, train, valid


def _manifests(cuts):
    return (jdata.CutManifest([jdata.Cut(**c) for c in cuts]),
            tdata.CutManifest([tdata.Cut(**c) for c in cuts]))


def _equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_features_read_across_packages(ds, writer):
    root, train, valid = ds
    cuts = train if writer == "jax" else valid
    jr, tr = jdata.FeatureReader(), tdata.FeatureReader()
    nr = tnative.NativeFeatureReader()
    for c in cuts:
        want = jr.read(c["feats_path"], c["feats_offset"], c["num_frames"])
        assert want.dtype == np.float32 and want.shape == (c["num_frames"], 80)
        np.testing.assert_array_equal(tr.read(c["feats_path"], c["feats_offset"], c["num_frames"]), want)
        np.testing.assert_array_equal(nr.read(c["feats_path"], c["feats_offset"], c["num_frames"]), want)


def _sampler_cuts():
    rng = np.random.RandomState(1)
    return [dict(id=f"c{i}", speaker="s", duration=float(rng.uniform(1.0, 9.0)), num_frames=1)
            for i in range(37)]


@pytest.mark.parametrize("kw", [
    dict(max_duration_batch=20.0, num_buckets=4),
    dict(max_duration_batch=None, max_cuts=5, num_buckets=1),
    dict(max_duration_batch=15.0, max_cuts=4, num_buckets=3, batch_divisor=2, seed=7),
    dict(max_duration_batch=30.0, num_buckets=2, batch_divisor=8, drop_last=True),
    dict(max_duration_batch=12.0, num_buckets=5, shuffle=False),
], ids=["duration", "count", "divisor2", "divisor8", "ordered"])
def test_sampler_plan_equals_jax_for_3_epochs(kw):
    jm, tm = _manifests(_sampler_cuts())
    js, ts = jdata.DurationBucketSampler(jm, **kw), tdata.DurationBucketSampler(tm, **kw)
    for epoch in range(3):
        js.set_epoch(epoch)
        ts.set_epoch(epoch)
        plan = list(ts)
        assert plan == list(js) and len(ts) == len(js) == len(plan)
        assert sorted({i for b in plan for i in b}) == sorted({i for b in js for i in b})


BATCHES = [[0, 3, 5, 7, 1], [2, 4, 6], [8, 9, 0, 1, 2, 3, 4, 5]]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("shards", ["one", "two"])
def test_gan_builder_bit_equal_to_jax(ds, native, shards):
    root, train, valid = ds
    cuts = train if shards == "one" else train[:6] + valid
    jm, tm = _manifests(cuts)
    jb = jdata.GANBatchBuilder(jm, root, seed=3, max_timbre_frames=512, use_native=native)
    tb = tdata.GANBatchBuilder(tm, root, seed=3, max_timbre_frames=512, use_native=native)
    assert (jb.native is not None) == native and (tb.native is not None) == native
    for idxs in BATCHES:
        idxs = [i % len(cuts) for i in idxs]
        a, b = jb(idxs), tb(idxs)
        B, T = a["mel_targets"].shape[:2]
        # the port leaves out shape_guard: hold it where JAX's guard changes nothing
        assert safe_target_frames(B, T, 512) == T
        _equal(a, b)
        assert b["mel_targets"].dtype == b["mel_timbres"].dtype == np.float16


def test_plm_builder_bit_equal_to_jax(ds):
    root, train, _ = ds
    jm, tm = _manifests(train)
    kw = dict(n_same_spk_samples=3, vq_bins=VQ_BINS, seed=5, max_tokens=40)
    jb, tb = jdata.PLMBatchBuilder(jm, root, **kw), tdata.PLMBatchBuilder(tm, root, **kw)
    for idxs in BATCHES:
        _equal(jb(idxs), tb(idxs))


def test_adm_builder_bit_equal_to_jax_and_skips(ds):
    root, train, _ = ds
    jm, tm = _manifests(train)
    cap = int(max(train[0]["duration_tokens"]))  # cut 0 and others are skipped
    jb, tb = jdata.ADMBatchBuilder(jm, root, cap), tdata.ADMBatchBuilder(tm, root, cap)
    outs = [tb(idxs) for idxs in BATCHES + [[0]]]
    for idxs, out in zip(BATCHES + [[0]], outs):
        _equal(jb(idxs), out)
    assert outs[-1] is None
    assert any(o is not None and len(o["lens"]) < len(i) for o, i in zip(outs, BATCHES))


def test_vocoder_builder_bit_equal_to_jax(ds):
    root, train, _ = ds
    jm, tm = _manifests(train)
    jb = jdata.VocoderBatchBuilder(jm, root, segment_frames=8, seed=2)
    tb = tdata.VocoderBatchBuilder(tm, root, segment_frames=8, seed=2)
    for idxs in BATCHES:
        _equal(jb(idxs), tb(idxs))


def test_loader_prefetches_skips_none_and_raises():
    def build(idxs):
        if idxs == [2]:
            return None
        if idxs == [9]:
            raise KeyError("bad cut")
        return {"x": np.asarray(idxs)}

    got = [b["x"].tolist() for b in tdata.DataLoader([[0], [1], [2], [3]], build)]
    assert got == [[0], [1], [3]]
    with pytest.raises(KeyError, match="bad cut"):
        list(tdata.DataLoader([[0], [9], [1]], build))
    it = iter(tdata.DataLoader([[i] for i in range(100)], build, prefetch=2))
    assert next(it)["x"].tolist() == [0]
    it.close()  # a consumer that stops early stops the producer


# ----------------------------------------------------------- native reader


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("shard") / "f.bin")
    rng = np.random.RandomState(0)
    arrays = [rng.randn(n, 80).astype(np.float32) for n in (33, 21, 7)]
    with tdata.FeatureWriter(p, dim=80) as w:
        offsets = [w.add(a)[1] for a in arrays]
    return p, [a.shape[0] for a in arrays], offsets


@pytest.fixture(scope="module")
def readers():
    if jnative.load_library() is None:
        pytest.fail("the JAX package's native reader did not build")
    return tnative.NativeFeatureReader(), jnative.NativeFeatureReader(), tdata.FeatureReader()


def test_native_read_batch_pads_like_jax_and_numpy(shard, readers):
    p, lens, offsets = shard
    tr, jr, npr = readers
    out = tr.read_batch(p, offsets, lens, 40)
    np.testing.assert_array_equal(out, jr.read_batch(p, offsets, lens, 40))
    assert out.shape == (3, 40, 80)
    for i, (o, n) in enumerate(zip(offsets, lens)):
        np.testing.assert_array_equal(out[i, :n], npr.read(p, o, n))
        assert not out[i, n:].any()
    for r in (tr, jr):  # a slice longer than pad_to is refused, not cut
        with pytest.raises(ValueError):
            r.read_batch(p, offsets, lens, 10)


def test_native_concat_slices_cut_like_jax(shard, readers):
    p, lens, offsets = shard
    tr, jr, npr = readers
    for cap in (40, 61, 100):
        got = tr.concat_slices(p, offsets, lens, cap)
        want = np.concatenate([npr.read(p, o, n) for o, n in zip(offsets, lens)])[:cap]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jr.concat_slices(p, offsets, lens, cap))


def test_native_out_of_range_read_rejected(shard, readers):
    p, lens, offsets = shard
    for r in readers[:2]:
        with pytest.raises(ValueError):
            r.read_batch(p, [offsets[-1]], [10_000], 10_000)
        with pytest.raises(ValueError):
            r.concat_slices(p, [offsets[-1] + 5], [lens[-1]], 40)


def test_native_ring_two_outstanding_tickets(shard, readers):
    p, lens, offsets = shard
    tr, jr, _ = readers
    ring = tr.ring_create(slots=2, max_floats=3 * 40 * 80)
    rev = (list(reversed(offsets)), list(reversed(lens)))
    t0 = ring.submit(p, offsets, lens, 40)
    t1 = ring.submit(p, *rev, 40)
    assert {t0, t1} == {0, 1}
    assert ring.submit(p, offsets, lens, 40) == -1  # every slot taken
    np.testing.assert_array_equal(ring.wait(t1, 3, 40), jr.read_batch(p, *rev, 40))
    np.testing.assert_array_equal(ring.wait(t0, 3, 40), jr.read_batch(p, offsets, lens, 40))
    ring.release(t0)
    ring.release(t1)
    t2 = ring.submit(p, offsets, lens, 33)  # a released slot is taken again
    assert t2 >= 0
    np.testing.assert_array_equal(ring.wait(t2, 3, 33), tr.read_batch(p, offsets, lens, 33))
    ring.release(t2)
    ring.close()


def test_native_build_failure_raises_without_fallback(ds, tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    and ``use_native=True`` raises with it: no numpy fallback."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("extern \"C\" int mtl_version() { return not_declared; }\n")
    with pytest.raises(RuntimeError, match="not_declared"):
        tnative.load_library(bad, tmp_path / "build")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    root, train, _ = ds
    with pytest.raises(RuntimeError, match="not_declared"):
        tdata.GANBatchBuilder(_manifests(train)[1], root, use_native=True)
    assert tdata.GANBatchBuilder(_manifests(train)[1], root, use_native=False).native is None


def test_gan_builder_releases_its_ring_slot_on_an_exception(ds, monkeypatch):
    """An exception while a batch is assembled leaves no ring slot taken:
    the next batches still go through the ring (as JAX's builder)."""
    root, train, _ = ds
    tb = tdata.GANBatchBuilder(_manifests(train)[1], root, seed=3, max_timbre_frames=512)
    want = tdata.GANBatchBuilder(_manifests(train)[1], root, seed=3, max_timbre_frames=512)(
        BATCHES[0])
    assemble = tb._assemble

    def fail_once(*a):
        monkeypatch.setattr(tb, "_assemble", assemble)
        raise KeyError("bad timbre cut")

    monkeypatch.setattr(tb, "_assemble", fail_once)
    for _ in range(2):  # both slots would be stranded after two failures
        with pytest.raises(KeyError, match="bad timbre"):
            tb(BATCHES[0])
        monkeypatch.setattr(tb, "_assemble", fail_once)
    monkeypatch.setattr(tb, "_assemble", assemble)
    tb.rng = np.random.RandomState(3)
    _equal(tb(BATCHES[0]), want)
    ring = tb._ring
    tickets = [ring.submit(train[0]["feats_path"], [0], [8], 8) for _ in range(2)]
    assert sorted(tickets) == [0, 1]
    for t in tickets:
        ring.wait(t, 1, 8)
        ring.release(t)
