"""Optimizers of the port: the local solver's SGD and prox forms, and
AdamW with its learning-rate schedules for the LM training step."""
from .adam import AdamState, adam_init, adam_step  # noqa: F401
from .prox import prox_grad_fn, solve_prox  # noqa: F401
from .schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
from .sgd import SGDState, sgd_init, sgd_state_step, sgd_step  # noqa: F401
