"""Training CLI of the port (port of ``megatts2_tpu/cli.py``): one entry
point for the four stages, on one card or on a mesh of ranks.

    python -m megatts2_tpu_torch.cli fit -c configs/config_gan.yaml [--stage gan]
    torchrun --nproc_per_node N -m megatts2_tpu_torch.cli fit -c configs/config_plm.yaml \
        --n_model M [--zero_opt]

The stage is ``--stage {gan,plm,adm,vocoder}`` or the config's model key.
Each stage reads the dataset that ``prepare_ds`` wrote (``data.ds_path``:
stage 1's manifests and features for gan and vocoder, stage 2's latents
for plm and adm), with JAX's samplers and builders: a fresh sampler and
builder each epoch, the builders (the ADM's aside) seeded with the epoch.
``--ckpt_path`` restores a given ``.ckpt``; otherwise the run resumes from
the latest checkpoint in ``--ckpt_dir`` (default ``checkpoints/<stage>``).
``--init_from_torch`` loads a reference ``.ckpt`` into G and D, the PLM or
the ADM and leaves the optimizer fresh.  The gan stage writes validation
artifacts under ``<log_dir>/val_artifacts`` (vocoded with
``--hifigan_ckpt``) and keeps the checkpoints with the best ``val/loss_re``.
Runs on the card unless ``--device cpu`` is given, and raises without one.

Under ``torchrun`` (or any process group already joined) the ranks form
an (N / M data × M model) mesh (``parallel/``): every rank builds the same
global batches, the sampler's sizes a multiple of the data axis
(``batch_divisor``), and trains on its rows; ``--n_model`` splits the
transformer layers over the model axis, ``--zero_opt`` shards the AdamW
moments over the data axis.  The step equals the one-process step on the
global batch.  Rank 0 writes the logs and the checkpoints, in the
one-device layout, which resume at any mesh.  NCCL on the card, gloo with
``--device cpu``; a card a rank under NCCL (``LOCAL_RANK``).

JAX's flags, plus ``--device``.  The root ``cli.py`` stays the JAX
package's.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="megatts2_tpu_torch training")
    p.add_argument("command", choices=["fit"], help="train a stage")
    p.add_argument("--config", "-c", required=True)
    p.add_argument("--stage", choices=["gan", "plm", "adm", "vocoder"], default=None)
    p.add_argument("--ckpt_path", default=None, help="restore this checkpoint (.ckpt)")
    p.add_argument("--init_from_torch", default=None,
                   help="reference Lightning .ckpt to initialize model weights"
                        " (G+D for gan, plm/adm otherwise; optimizer fresh)")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--ckpt_dir", default=None)
    p.add_argument("--trace_dir", default=None, help="torch.profiler trace of steps 10-12")
    p.add_argument("--n_model", type=int, default=1, help="tensor-parallel axis size")
    p.add_argument("--zero_opt", action="store_true",
                   help="ZeRO-1: shard optimizer moments of replicated "
                        "params over the data axis (memory ↓ at scale)")
    p.add_argument("--hifigan_ckpt", default=None,
                   help="HiFi-GAN checkpoint for vocoded validation audio (gan stage)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _read_config(path: str) -> dict:
    from .config import yaml_load

    with open(path, encoding="utf-8") as f:
        return yaml_load(f.read()) or {}


def infer_stage(config_path: str) -> str:
    model = _read_config(config_path).get("model") or {}
    for key, stage in (("G", "gan"), ("plm", "plm"), ("adm", "adm"), ("vocoder", "vocoder")):
        if key in model:
            return stage
    raise ValueError("cannot infer stage from config; pass --stage")


def _data_cfg(config_path: str) -> dict:
    return _read_config(config_path).get("data") or {}


def _init_from_torch(path: str, *modules) -> None:
    """Load a reference-layout checkpoint's weights into ``modules``."""
    from .training.checkpoints import load_model_state_dict, read_checkpoint

    obj = read_checkpoint(path)
    for m in modules:
        load_model_state_dict(m, obj.get("state_dict", obj))


def main(argv=None):
    """Train one stage; returns its train state."""
    args = parse_args(argv)
    stage = args.stage or infer_stage(args.config)
    ckpt_dir = args.ckpt_dir or os.path.join("checkpoints", stage)

    from .data import (ADMBatchBuilder, CutManifest, DataLoader, DurationBucketSampler,
                       GANBatchBuilder, PLMBatchBuilder, VocoderBatchBuilder)
    from .parallel import make_mesh, maybe_initialize_distributed, place_train_state
    from .training import run_training

    dcfg = _data_cfg(args.config)
    ds_path = dcfg.get("ds_path", "data/ds/")
    min_d, max_d = dcfg.get("min_duration", 1.5), dcfg.get("max_duration", 20)
    manifests = {
        split: CutManifest.load(os.path.join(ds_path, f"cuts_{split}.jsonl.gz"))
        .filter_duration(min_d, max_d)
        for split in ("train", "valid")
    }
    maybe_initialize_distributed(device=args.device)
    mesh = make_mesh(n_model=args.n_model)

    def place(state):
        """The state on the mesh (weights loaded; run_training restores into it)."""
        return place_train_state(state, mesh, zero=args.zero_opt)

    def loaders(builder_cls, sampler_kwargs, builder_kwargs=None):
        def factory(split):
            def make(epoch):
                sampler = DurationBucketSampler(manifests[split], batch_divisor=mesh.n_data,
                                                **sampler_kwargs)
                sampler.set_epoch(epoch)
                kw = dict(builder_kwargs or {})
                if builder_cls is not ADMBatchBuilder:
                    kw.setdefault("seed", epoch)  # fresh same-speaker draws each epoch
                return DataLoader(sampler, builder_cls(manifests[split], ds_path, **kw))

            return make

        return factory("train"), factory("valid")

    common = dict(log_dir=args.log_dir, ckpt_dir=ckpt_dir, trace_dir=args.trace_dir,
                  ckpt_path=args.ckpt_path)
    if stage == "gan":
        from .config import load_gan_config
        from .training import (create_gan_state, make_gan_eval_step, make_gan_train_step,
                               make_gan_val_artifacts)

        g_cfg, d_cfg, tcfg = load_gan_config(args.config)
        train_f, valid_f = loaders(
            GANBatchBuilder,
            dict(max_duration_batch=dcfg.get("max_duration_batch", 60),
                 num_buckets=dcfg.get("num_buckets", 10)),
            # the cap of the same-speaker timbre concat (reference 2048)
            dict(max_timbre_frames=dcfg.get("max_timbre_frames", 2048)))
        state = create_gan_state(g_cfg, d_cfg, tcfg, device=args.device)
        if args.init_from_torch:
            _init_from_torch(args.init_from_torch, state.g, state.d)
        place(state)
        eval_fn = make_gan_eval_step(g_cfg)
        vocoder = None
        if args.hifigan_ckpt:
            from .models.pretrained import hifigan_from_pretrained

            vocoder = hifigan_from_pretrained(args.hifigan_ckpt)[1].to(args.device)
        artifact_fn = make_gan_val_artifacts(g_cfg, os.path.join(args.log_dir, "val_artifacts"),
                                             vocoder)
        return run_training(
            "gan", state, make_gan_train_step(g_cfg, d_cfg, tcfg), train_f, tcfg.max_steps,
            log_every=tcfg.log_every_n_steps, val_every=tcfg.val_check_interval,
            save_every_n_vals=tcfg.save_every_n_vals,
            eval_step=lambda s, b: {"loss_re": eval_fn(s, b)["loss_re"]},
            valid_loader_factory=valid_f, artifact_fn=artifact_fn, monitor="loss_re", **common)
    if stage == "plm":
        from .config import load_plm_config
        from .training import create_plm_state, make_plm_train_step

        cfg, tcfg = load_plm_config(args.config)
        train_f, valid_f = loaders(
            PLMBatchBuilder,
            dict(max_duration_batch=None, max_cuts=dcfg.get("max_n_cuts", 15), num_buckets=1),
            dict(vq_bins=cfg.vq_bins))
        state = create_plm_state(cfg, tcfg, device=args.device)
        if args.init_from_torch:
            _init_from_torch(args.init_from_torch, state.model)
        place(state)
        step_fn, eval_fn = make_plm_train_step(cfg, tcfg)
        return run_training(
            "plm", state, step_fn, train_f, tcfg.max_steps,
            log_every=tcfg.log_every_n_steps, val_every=tcfg.val_check_interval,
            save_every_n_vals=tcfg.save_every_n_vals, eval_step=eval_fn,
            valid_loader_factory=valid_f, **common)
    if stage == "vocoder":
        from .config import load_vocoder_config
        from .training import (create_vocoder_state, make_vocoder_eval_step,
                               make_vocoder_train_step)

        if args.init_from_torch:
            raise ValueError("--init_from_torch: the reference has no vocoder stage to load")
        voc_cfg, d_cfg, tcfg = load_vocoder_config(args.config)
        train_f, valid_f = loaders(
            VocoderBatchBuilder,
            dict(max_duration_batch=None, max_cuts=dcfg.get("batch_size", 16), num_buckets=1),
            dict(segment_frames=tcfg.segment_frames))
        state = place(create_vocoder_state(voc_cfg, d_cfg, tcfg, device=args.device))
        eval_fn = make_vocoder_eval_step(voc_cfg, tcfg)
        return run_training(
            "vocoder", state, make_vocoder_train_step(voc_cfg, d_cfg, tcfg), train_f,
            tcfg.max_steps, log_every=tcfg.log_every_n_steps,
            val_every=tcfg.val_check_interval, save_every_n_vals=tcfg.save_every_n_vals,
            eval_step=lambda s, b: {"loss": eval_fn(s, b)["loss"]},
            valid_loader_factory=valid_f, **common)
    # adm
    from .config import load_adm_config
    from .training import create_adm_state, make_adm_train_step

    cfg, tcfg = load_adm_config(args.config)
    train_f, valid_f = loaders(
        ADMBatchBuilder,
        dict(max_duration_batch=dcfg.get("max_duration_batch", 400),
             num_buckets=dcfg.get("num_buckets", 10)),
        dict(max_duration_token=cfg.max_duration_token))
    state = create_adm_state(cfg, tcfg, device=args.device)
    if args.init_from_torch:
        _init_from_torch(args.init_from_torch, state.model)
    place(state)
    step_fn, eval_fn = make_adm_train_step(cfg, tcfg)
    return run_training(
        "adm", state, step_fn, train_f, tcfg.max_steps,
        log_every=tcfg.log_every_n_steps, val_every=tcfg.val_check_interval,
        save_every_n_vals=tcfg.save_every_n_vals, eval_step=eval_fn,
        valid_loader_factory=valid_f, **common)


if __name__ == "__main__":
    main()
