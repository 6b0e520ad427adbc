"""Plain PyTorch reference of the learned-mask policy, against which the
benchmark judges what the program's timed path produced. It imports no
module of the program and is written from the method's description (the
reference paper's UNet, weight lookup, differentiable ICP and loss), not
from the program's code."""
