"""Plain PyTorch references of the learned-mask policy, against which the
benchmark judges what the program's timed path produced. They are written
from the method's description (the reference paper's UNet, weight lookup,
differentiable ICP and loss), not from the program's code, and a reference
file imports nothing of the program, nor JAX.

Each configuration is checked against a reference found by its name:
``reference/<config>.py`` where that file exists, ``reference/policy.py``
otherwise (``cells.reference``). A configuration whose mechanism the plain
policy does not compute (the gated solve, implicit gradients, batch norm)
brings its own file. A reference module has these functions:

* ``check_config(cfg)``: raise where ``cfg`` (a configuration file's
  ``config`` block) asks for what the reference does not compute;
* ``start_params(model, seed, device) -> {name: tensor}``: the starting
  parameters made from the seed, under the program's parameter names and
  shapes (the harness loads them into the program's state);
* ``train_steps(cfg, start, batches, dropout_seed, device, lower=False)
  -> (losses, first clipped gradients, parameters after the last step)``;
* ``eval_step(cfg, start, batch, lower=False) -> (error triple (3,),
  normalised mask (B, H, W))``.

``lower=True`` computes the configuration's activations in the next lower
precision: the control.
"""
