"""Test-size configurations and traffic: every kind of layer of the cells'
configurations at small widths, on the CPU."""
TINY = {
    "g": {"mrte": {"mel_bins": 80, "mel_activation": "ReLU", "mel_kernel_size": 3,
                   "mel_stride": 16, "mel_n_layer": 2, "mel_n_stack": 1, "mel_n_block": 1,
                   "content_ff_dim": 64, "content_n_heads": 2, "content_n_layers": 2,
                   "hidden_size": 32, "phone_vocab_size": 320},
          "vqpe": {"mel_bins": 20, "stride": 8, "hidden_size": 16, "kernel_size": 5,
                   "n_layers": 1, "n_stacks": 1, "n_blocks": 1, "vq_bins": 64, "vq_dim": 16},
          "kernel_size": 5, "hidden_size": 32, "decoder_n_stack": 1, "decoder_n_block": 2},
    "plm": {"n_layers": 2, "n_heads": 2, "vq_dim": 32, "tc_latent_dim": 32, "vq_bins": 64,
            "dropout": 0.1, "use_flash": True},
    "adm": {"n_layers": 2, "n_heads": 2, "emb_dim": 16, "tc_latent_dim": 32, "tc_emb_dim": 32,
            "max_duration_token": 128},
    "vocoder": {"in_channels": 80, "dim": 32, "intermediate_dim": 48, "num_layers": 2,
                "n_fft": 1024, "hop_length": 256, "mag_clip": 100.0},
    "dtype": "bfloat16", "quant_int8": True,
}
TINY_TRAIN = {
    "plm": {"n_layers": 2, "n_heads": 2, "vq_dim": 32, "tc_latent_dim": 32, "vq_bins": 64,
            "dropout": 0.1, "use_flash": True},
    "train": {"initial_learning_rate": 1e-4, "warmup_steps": 200, "max_steps": 100000,
              "train_dtype": "bfloat16", "start_step": 200, "b1": 0.9, "b2": 0.999,
              "eps": 1e-8, "weight_decay": 0.01},
}
TRAFFIC_SYNTH = {"runner": "synth", "batch": 2, "phones": 16, "phone_ids": [1, 319],
                 "prompt_frames": 64, "prompt_pool": 3, "max_frames": 64, "pool_batches": 3,
                 "check_batches": 2, "trace_start_s": 0.0, "trace_seconds": 1.0}
TRAFFIC_TRAIN = {"runner": "train", "batch": 4, "cuts_per_row": 3, "cut_seconds": [0.3, 1.0],
                 "frame_rate": 62.5, "frames_per_code": 8, "max_tokens": 40, "pad_multiple": 4,
                 "sizes_seed": 1, "pool_batches": 5, "checked_steps": 3, "trace_start_s": 0.0,
                 "trace_seconds": 1.0}
