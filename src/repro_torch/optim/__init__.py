"""Local solver optimizers of the port."""
from .prox import prox_grad_fn, solve_prox  # noqa: F401
from .sgd import SGDState, sgd_init, sgd_state_step, sgd_step  # noqa: F401
