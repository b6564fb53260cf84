from .gan_trainer import GANTrainState, create_gan_state, make_gan_eval_step, make_gan_train_step
from .lm_trainers import (TrainState, create_adm_state, create_plm_state,
                          make_adm_train_step, make_plm_train_step, top_k_accuracy)
from .schedules import cosine_schedule_with_warmup, make_adamw
from .train_loop import run_training
