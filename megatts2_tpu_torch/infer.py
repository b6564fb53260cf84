"""Inference CLI of the port (port of ``megatts2_tpu/infer.py``): zero-shot
synthesis from prompt wavs and a text, ``Megatts(...)(wavs_dir, text)``.

    python -m megatts2_tpu_torch.infer --wavs_dir prompts/spk1 --text "..." \\
        --g_ckpt G.ckpt --plm_ckpt plm.ckpt --adm_ckpt adm.ckpt --symbol_table ...

It reads reference Lightning checkpoints and the port's own (``.ckpt``,
``.pt``, ``.pth``); a missing G, PLM or ADM checkpoint gives seeded random
weights (smoke runs).  It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="megatts2_tpu_torch zero-shot TTS")
    p.add_argument("--wavs_dir", required=True, help="dir with prompt *.wav files")
    p.add_argument("--text", required=True)
    p.add_argument("--out", default="test.wav")
    p.add_argument("--g_ckpt", default=None)
    p.add_argument("--g_config", default="configs/config_gan.yaml")
    p.add_argument("--plm_ckpt", default=None)
    p.add_argument("--plm_config", default="configs/config_plm.yaml")
    p.add_argument("--adm_ckpt", default=None)
    p.add_argument("--adm_config", default="configs/config_adm.yaml")
    p.add_argument("--hifigan_ckpt", default=None)
    p.add_argument("--vocoder", choices=["hifigan", "vocos"], default="hifigan")
    p.add_argument("--vocoder_ckpt", default=None,
                   help="checkpoint of the port's vocoder training stage (overrides --hifigan_ckpt)")
    p.add_argument("--vocoder_config", default="configs/config_vocoder.yaml")
    p.add_argument("--symbol_table", default="data/ds/unique_text_tokens.k2symbols")
    p.add_argument("--pinyin_dict", default=None)
    p.add_argument("--max_frames", type=int, default=2048)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="bfloat16")
    p.add_argument("--quant_int8", action="store_true", help="int8 weight-only PLM decode")
    p.add_argument("--plm_temperature", type=float, default=0.0,
                   help=">0: sample prosody codes instead of greedy argmax")
    p.add_argument("--plm_top_k", type=int, default=0,
                   help="truncate sampling to the k most likely codes")
    p.add_argument("--seed", type=int, default=0, help="sampling seed")
    p.add_argument("--plm_prompt_ds", default=None,
                   help="prepared dataset root with stage-2 latents/: an in-context prosody prompt")
    p.add_argument("--plm_prompt_cuts", default=None,
                   help="comma-separated cut ids of the prompt (default: the first "
                        "--plm_prompt_n cuts of --plm_prompt_speaker)")
    p.add_argument("--plm_prompt_speaker", default=None)
    p.add_argument("--plm_prompt_n", type=int, default=3)
    p.add_argument("--plm_prompt_max_tokens", type=int, default=2048)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .config import load_adm_config, load_gan_config, load_plm_config
    from .models import MegaADM, MegaG, MegaPLM, Megatts, init_random_
    from .models.pretrained import (adm_from_pretrained, megag_from_pretrained,
                                    plm_from_pretrained, vocoder_from_pretrained)

    def load(ckpt, loader, config, build):
        if ckpt:
            return loader(ckpt, config)[1]
        with torch.no_grad():
            return init_random_(build(), torch.Generator().manual_seed(args.seed)).eval()

    g = load(args.g_ckpt, megag_from_pretrained, args.g_config,
             lambda: MegaG(load_gan_config(args.g_config)[0]))
    plm = load(args.plm_ckpt, plm_from_pretrained, args.plm_config,
               lambda: MegaPLM(load_plm_config(args.plm_config)[0]))
    adm = load(args.adm_ckpt, adm_from_pretrained, args.adm_config,
               lambda: MegaADM(load_adm_config(args.adm_config)[0]))
    _, voc = vocoder_from_pretrained(args.vocoder, args.vocoder_ckpt, args.hifigan_ckpt,
                                     args.vocoder_config, seed=args.seed)
    tts = Megatts(g, plm, adm, voc, args.symbol_table, pinyin_dict_path=args.pinyin_dict,
                  max_frames=args.max_frames, dtype=_DTYPES[args.dtype], device=args.device,
                  quant_int8=args.quant_int8, plm_temperature=args.plm_temperature,
                  plm_top_k=args.plm_top_k, seed=args.seed)
    pf = None
    if args.plm_prompt_ds:
        from .data import resolve_prompt

        pf = resolve_prompt(args.plm_prompt_ds,
                            cut_ids=args.plm_prompt_cuts.split(",") if args.plm_prompt_cuts else None,
                            speaker=args.plm_prompt_speaker, n=args.plm_prompt_n,
                            max_tokens=args.plm_prompt_max_tokens)
    wav = tts(args.wavs_dir, args.text, out_path=args.out, prompt_features=pf)
    print(f"wrote {args.out}: {wav.shape[0] / 16000:.2f}s")
    return wav


if __name__ == "__main__":
    main()
