from .checkpoints import (best_checkpoint, latest_checkpoint, load_model_state_dict,
                          model_state_dict, restore_checkpoint, save_checkpoint)
from .gan_trainer import (GANTrainState, create_gan_state, make_gan_eval_step, make_gan_train_step,
                          make_gan_val_artifacts)
from .lm_trainers import (TrainState, create_adm_state, create_plm_state,
                          make_adm_train_step, make_plm_train_step, top_k_accuracy)
from .schedules import adamw, cosine_schedule_with_warmup, exponential_decay, make_adamw
from .train_loop import run_training
from .vocoder_trainer import (VocoderTrainState, create_vocoder_state, make_vocoder_eval_step,
                              make_vocoder_train_step)
