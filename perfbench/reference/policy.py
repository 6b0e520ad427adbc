"""The learned ICP-weight policy in plain PyTorch: UNet mask → per-point
weights → weighted Gauss-Newton ICP → loss, and Adam.

Method (arXiv:2309.08731 and its code, ``icp_weight_policy.py``,
``radar_utils.py``, ``train_icp_weights.py``):

* The UNet: encoder blocks conv3x3-ReLU-conv3x3-ReLU[-dropout], a 2x2
  max-pool after every block but the first, the skip of each block its
  input; each decoder block applied twice with its weights, on the
  bilinearly upsampled (align-corners) features and on ``cat([skip, x])``;
  a 1x1 head and a sigmoid. The input is the batch's min-max normalised
  FFT image. Activations are in the configuration's type (``bfloat16``:
  each conv's input, weights and bias rounded to it, their products summed
  in float32, the ReLU's result rounded to it; the head sums its products
  alike); the head's result and its sigmoid are float32. The weights stay
  float32, and a rounding passes their gradient unchanged.
  Dropout keeps an element with probability 1 − rate and scales it by
  1 / (1 − rate); its uniform draws come from a ``torch.Generator`` in the
  order the blocks run, one draw of the block's output shape each time.
* The mask is divided by its per-image maximum (capped at 1); a polar mask
  is warped to the cartesian grid. Each scan point's weight is the mask
  sampled bilinearly at its pixel; pad points (x = y = 0) get 0.
* ICP: the scan transformed by T, each point's nearest map point (exact,
  over the whole map), residual ``n·(p − q)`` (pt2pl) or ``p − q``
  (pt2pt), Cauchy weights (k = 1) on the residual's size times the mask's
  weight, pairs farther than 5 m trimmed; the weighted normal equations'
  planar block (x, y, yaw), damped by 1e-9 + 1e-7·trace/3, solved; T ←
  exp(δ)·T. Training unrolls ``max_iter`` iterations, differentiable in the
  weights (the association taken on detached points); inference runs up to
  ``inference_max_iter``, each item frozen once its update's norm is under
  1e-5.
* The loss (ground truth the identity): the mean |sin yaw| and the mean
  translation norm of the estimate, the BCE of the mask against the map
  points' bird's-eye occupancy, and the point-count hinge; Adam as optax
  builds it (elementwise clip, then Adam; a step with a non-finite gradient
  changes nothing).

Everything is float32 unless the configuration says otherwise, with TF32
off. ``lower=True`` computes the configuration's activations in the next
lower precision (the control): the conv operands in float8 (e4m3) for
bfloat16, TF32 products for float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from perfbench.generator import pad_crossover, polar_warp_grid, xavier_params

TRIM_M = 5.0
CAUCHY_K = 1.0
DAMPING, DAMPING_REL = 1e-9, 1e-7
TOLERANCE = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PLANAR = (0, 1, 5)  # x, y, yaw of the twist (ρ, φ)

# What the reference implements; a configuration that states otherwise is refused.
_MODEL_STATES = {
    "fft_input": True, "cfar_input": False, "range_input": False, "leaky": False,
    "batch_norm": False, "log_transform": False, "normalize": "minmax", "norm_weights": True,
    "binary_inference": False, "nn_refresh_dist": 0.0, "icp_diff_mode": "unroll",
    "gt_eye": True, "icp_max_step_m": 0.0, "icp_overrides": [],
}


def check_config(cfg: dict) -> None:
    """Raise where ``cfg`` (a config file's ``config`` block) asks for what
    this reference does not compute."""
    model = cfg["model"]
    for key, want in _MODEL_STATES.items():
        if key in model and model[key] != want:
            raise NotImplementedError(f"the reference computes model.{key}={want!r}, the "
                                      f"configuration states {model[key]!r}")
    if cfg["loss"].get("fft", 0.0) or cfg["loss"].get("cfar", 0.0):
        raise NotImplementedError("the reference has no FFT or CFAR mask loss")
    train = cfg["train"]
    if train.get("optimizer", "adam") != "adam" or train.get("lr_schedule",
                                                               "constant") != "constant":
        raise NotImplementedError("the reference trains with Adam at a constant rate")


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in float32 (TF32 off), or in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def param_shapes(enc_channels, in_channels: int = 1) -> dict[str, tuple[int, ...]]:
    """The parameters' names and shapes: ``blocks.<i>.conv<0|1>.{weight,bias}``
    (OIHW) for the encoder blocks, then the decoder blocks, and
    ``final.{weight,bias}`` for the 1x1 head."""
    enc = list(enc_channels)
    dec = enc[::-1]
    ios = []
    cin = in_channels
    for ch in enc:
        ios.append((cin, ch))
        cin = ch
    ios += [(dec[i], dec[i + 1]) for i in range(len(dec) - 1)]
    shapes = {}
    for i, (ci, co) in enumerate(ios):
        shapes[f"blocks.{i}.conv0.weight"] = (co, ci, 3, 3)
        shapes[f"blocks.{i}.conv0.bias"] = (co,)
        shapes[f"blocks.{i}.conv1.weight"] = (co, co, 3, 3)
        shapes[f"blocks.{i}.conv1.bias"] = (co,)
    shapes["final.weight"] = (1, enc[0], 1, 1)
    shapes["final.bias"] = (1,)
    return shapes


def start_params(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The UNet's starting parameters from the seed: Xavier-uniform kernels
    and zero biases."""
    return xavier_params(param_shapes(model["enc_channels"]), seed, device)


def _rounded(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """float32 x with its values rounded to ``dtype`` in the forward pass (the
    gradient passes unchanged); x itself for None."""
    if dtype is None:
        return x
    return x + (x.to(dtype).float() - x).detach()


class Net:
    """The UNet of a configuration, at its activation type."""

    def __init__(self, model: dict, lower: bool = False):
        self.enc = list(model["enc_channels"])
        self.act = torch.bfloat16 if model["dtype"] == "bfloat16" else torch.float32
        self.rate = float(model["dropout"])
        # A conv's operands take the activations' type, or float8 (e4m3) in the
        # control; float32's lower step is TF32 instead (precision()).
        self.operand = None
        if self.act == torch.bfloat16:
            self.operand = torch.float8_e4m3fn if lower else torch.bfloat16

    def _conv(self, params, name, x):
        """ReLU of the conv of x and the weight, both rounded to the operand
        type, with the bias (rounded alike), summed in float32; the result
        rounded to the activations' type."""
        w = _rounded(params[f"{name}.weight"].float(), self.operand)
        b = _rounded(params[f"{name}.bias"].float(), self.operand)
        y = F.conv2d(_rounded(x.float(), self.operand), w, b, padding=1)
        return F.relu(y).to(self.act)

    def _block(self, params, i, x, train, gen, pool):
        x = self._conv(params, f"blocks.{i}.conv0", x)
        x = self._conv(params, f"blocks.{i}.conv1", x)
        if train and self.rate > 0.0:
            keep_prob = 1.0 - self.rate
            u = torch.rand(x.shape, generator=gen, device=x.device)
            x = torch.where(u < keep_prob, x / keep_prob,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        return F.max_pool2d(x, 2, 2) if pool else x

    def __call__(self, params: dict, image: torch.Tensor, train: bool = False,
                 gen: torch.Generator | None = None) -> torch.Tensor:
        """(B, H, W) input image → (B, H, W) float32 mask in (0, 1)."""
        x = image[:, None].float()
        c_max = x.amax(dim=(0, 2, 3), keepdim=True)
        c_min = x.amin(dim=(0, 2, 3), keepdim=True)
        x = ((x - c_min) / torch.clamp(c_max - c_min, min=1e-30)).to(self.act)
        n = len(self.enc)
        skips = []
        for i in range(n):
            skips.append(x)
            x = self._block(params, i, x, train, gen, pool=i > 0)
        for j, skip in enumerate(reversed(skips[1:])):
            h, w = skip.shape[2:]
            x = F.interpolate(x, size=(h, x.shape[3]), mode="bilinear", align_corners=True)
            x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
            x = self._block(params, n + j, x, train, gen, pool=False)
            x = self._block(params, n + j, torch.cat([skip, x], dim=1), train, gen, pool=False)
        w = _rounded(params["final.weight"].float(), self.operand)[:, :, 0, 0]
        b = _rounded(params["final.bias"].float(), self.operand)
        y = torch.einsum("oc,bchw->bohw", w, _rounded(x.float(), self.operand))
        y = y + b[None, :, None, None]
        return torch.sigmoid(y)[:, 0]


def normalise_mask(mask: torch.Tensor) -> torch.Tensor:
    return torch.minimum(mask / mask.amax(dim=(1, 2), keepdim=True), mask.new_ones(()))


def cartesian_mask(model: dict, mask: torch.Tensor, azimuths: torch.Tensor) -> torch.Tensor:
    """The mask on the cartesian grid: a polar mask warped there."""
    if model["network_output_type"] != "polar":
        return mask
    grid = polar_warp_grid(azimuths, mask.shape[2], model["res"], model["cart_resolution"],
                           model["cart_pixel_width"])
    return F.grid_sample(pad_crossover(mask)[:, None], grid, mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, 0]


def point_weights(mask: torch.Tensor, pc: torch.Tensor, res: float, width: int) -> torch.Tensor:
    """Each scan point's weight: the mask (B, W, W) sampled bilinearly at the
    point's pixel (row from −x, column from y, centred); pad points 0."""
    pc = pc.to(mask.dtype)
    grid = torch.stack([pc[..., 1] / res, -pc[..., 0] / res], dim=-1) / (width - 1) * 2
    pad = (pc[..., 0] == 0.0) & (pc[..., 1] == 0.0)
    grid = torch.where(pad[..., None], torch.full_like(grid, -100.0), grid)
    return F.grid_sample(mask[:, None], grid[:, :, None, :], mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, 0, :, 0]


def _hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(B, 6) twists (ρ, φ) → (B, 4, 4): Rodrigues' rotation and the left
    Jacobian applied to ρ, with Taylor terms for small angles."""
    rho, phi = xi[:, :3], xi[:, 3:]
    sq = (phi * phi).sum(-1)
    small = sq < 1e-8
    safe = torch.where(small, torch.ones_like(sq), sq)
    th = torch.sqrt(safe)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(th)) / safe)
    c = torch.where(small, 1.0 / 6.0 - sq / 120.0, (th - torch.sin(th)) / (safe * th))
    K = _hat(phi)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(K)
    R = eye + a[:, None, None] * K + b[:, None, None] * K2
    V = eye + b[:, None, None] * K + c[:, None, None] * K2
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[:, :1])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=1)


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return p @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]


def nearest(p: torch.Tensor, q: torch.Tensor, elems: int = 1 << 28) -> torch.Tensor:
    """Index (B, N) of each point's nearest map point by the exact squared
    distance; the first of equals; NaN distances never chosen."""
    B, N, _ = p.shape
    M = q.shape[1]
    per = max(1, elems // (N * M))
    out = []
    for b0 in range(0, B, per):
        pp, qq = p[b0:b0 + per, :, None, :], q[b0:b0 + per, None, :, :]
        d2 = ((pp[..., 0] - qq[..., 0]) ** 2 + (pp[..., 1] - qq[..., 1]) ** 2
              + (pp[..., 2] - qq[..., 2]) ** 2)
        out.append(torch.nan_to_num(d2, nan=math.inf).argmin(dim=-1))
    return torch.cat(out)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def gn_step(T, src, valid, weight, tgt, nrm, idx, icp_type: str):
    """One Gauss-Newton step from the association ``idx`` → (T_new, δ (B, 6))."""
    p = transform(T, src)
    diff = p - _gather(tgt, idx)
    dist = torch.linalg.vector_norm(diff + 1e-30, dim=-1)
    active = torch.isfinite(dist) & (dist < TRIM_M)
    if icp_type == "pt2pl":
        n = _gather(nrm, idx)
        r = (n * diff).sum(-1)
        r_size = r.abs()
    else:
        r, r_size = diff, dist
    w = 1.0 / (1.0 + (torch.where(active, r_size, 1.0) / CAUCHY_K) ** 2)
    w = torch.where(active, w, 0.0) * valid * weight
    p = torch.where(active[..., None], p, 0.0)
    if icp_type == "pt2pl":
        n = torch.where(active[..., None], n, 0.0)
        r = torch.where(active, r, 0.0)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # (B, N, 6)
        A = torch.einsum("bni,bnj->bij", J * w[..., None], J)
        b = -torch.einsum("bni,bn->bi", J, w * r)
    else:
        r = torch.where(active[..., None], r, 0.0)
        eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(*p.shape[:2], 3, 3)
        J = torch.cat([eye, -_hat(p)], dim=-1)  # (B, N, 3, 6)
        A = torch.einsum("bnki,bnkj->bij", J * w[..., None, None], J)
        b = -torch.einsum("bnki,bnk->bi", J, w[..., None] * r)
    sel = list(PLANAR)
    A3 = A[:, sel][:, :, sel]
    lam = DAMPING + DAMPING_REL * A3.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    A3 = A3 + lam[:, None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    x = torch.linalg.solve(A3, b[:, sel])
    zero = torch.zeros_like(x[:, :1])
    delta = torch.cat([x[:, :2], zero, zero, zero, x[:, 2:]], dim=-1)
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return se3_exp(delta) @ T, delta


def _icp_inputs(batch: dict):
    src = batch["loc_data"]["filtered_pc"][..., :3].float()
    valid = (~((src[..., 0] == 0.0) & (src[..., 1] == 0.0))).float()
    pc = batch["map_data"]["pc"].float()
    return src, valid, pc[..., :3], pc[..., 3:6]


def icp_train(model: dict, batch: dict, weight: torch.Tensor) -> torch.Tensor:
    """``max_iter`` unrolled steps from T_init, differentiable in ``weight``."""
    src, valid, tgt, nrm = _icp_inputs(batch)
    T = batch["transforms"]["T_ml_init"].float()
    for _ in range(int(model["max_iter"])):
        idx = nearest(transform(T, src).detach(), tgt)
        T, _ = gn_step(T, src, valid, weight, tgt, nrm, idx, model["icp_type"])
    return T


@torch.no_grad()
def icp_solve(model: dict, batch: dict, weight: torch.Tensor) -> torch.Tensor:
    """Up to ``inference_max_iter`` steps; an item stops once its update's
    norm is under the tolerance."""
    src, valid, tgt, nrm = _icp_inputs(batch)
    T = batch["transforms"]["T_ml_init"].float().clone()
    dn = torch.full((T.shape[0],), math.inf, device=T.device)
    for _ in range(int(model["inference_max_iter"])):
        run = dn >= TOLERANCE
        if not bool(run.any()):
            break
        idx = nearest(transform(T, src), tgt)
        T_new, delta = gn_step(T, src, valid, weight, tgt, nrm, idx, model["icp_type"])
        T = torch.where(run[:, None, None], T_new, T)
        dn = torch.where(run, torch.linalg.vector_norm(delta, dim=-1), dn)
    return T


def bev_occupancy(pc: torch.Tensor, res: float, width: int) -> torch.Tensor:
    """The map points' bird's-eye occupancy (B, W, W): the four floor/ceil
    pixels of each point set to 1; points off the image (pads included)
    fall on the centre pixel, which is cleared."""
    u = -pc[..., 0] / res + width / 2
    v = pc[..., 1] / res + width / 2
    mid = float(width // 2)
    idx = torch.stack([u, v], dim=-1)
    idx = torch.where((idx < 0) | (idx > width - 1), mid, idx)
    B = pc.shape[0]
    bev = torch.zeros((B, width, width), dtype=pc.dtype, device=pc.device)
    b = torch.arange(B, device=pc.device)[:, None].expand_as(idx[..., 0])
    for uu in (torch.floor(idx[..., 0]), torch.ceil(idx[..., 0])):
        for vv in (torch.floor(idx[..., 1]), torch.ceil(idx[..., 1])):
            bev[b, uu.long(), vv.long()] = 1.0
    bev[:, width // 2, width // 2] = 0.0
    return bev


def pose_errors(T: torch.Tensor):
    """(sin yaw (B,), translation (B, 2)) of estimates against the identity."""
    return T[:, 1, 0], T[:, :2, 3]


def train_loss(cfg: dict, net: Net, params: dict, batch: dict, gen) -> torch.Tensor:
    model, weights = cfg["model"], cfg["loss"]
    scan = batch["loc_data"]
    mask = normalise_mask(net(params, scan["fft_data"], train=True, gen=gen))
    cart = cartesian_mask(model, mask, scan["azimuths"])
    res, width = model["cart_resolution"], model["cart_pixel_width"]
    w = point_weights(cart, scan["raw_pc"], res, width)
    T = icp_train(model, batch, w)
    sin_yaw, trans = pose_errors(T)
    loss = (weights.get("icp_rot", 1.0) * sin_yaw.abs().mean()
            + weights.get("icp_trans", 1.0) * torch.linalg.vector_norm(trans, dim=-1).mean())
    if weights.get("mask_pts", 0.0) > 0.0:
        bev = bev_occupancy(batch["map_data"]["pc"][..., :3].float(), res, width)
        loss = loss + weights["mask_pts"] * F.binary_cross_entropy(mask, bev)
    if weights.get("num_pts", 0.0) > 0.0:
        raw = scan["raw_pc"]
        B = raw.shape[0]
        real = ~((raw[..., 0] == 0.0) & (raw[..., 1] == 0.0))
        all_pts = ((raw[..., 0] != 0.0) & (raw[..., 1] != 0.0)).sum() / B
        soft = torch.where(real, 0.5 * torch.tanh(5.0 * w) + 0.5, 0.0).sum() / B
        floor = weights.get("num_pts_floor", 0.0)
        term = (torch.clamp(floor * all_pts - soft, min=0.0) if floor > 0.0
                else all_pts - soft)
        loss = loss + weights["num_pts"] * term
    return loss


def train_steps(cfg: dict, params: dict, batches: list, dropout_seed: int, device,
                lower: bool = False):
    """Train from ``params`` on ``batches``, one Adam step each → (the
    losses, the first step's clipped gradients, the parameters after the
    last step). Dropout draws from a generator seeded ``dropout_seed``."""
    check_config(cfg)
    net = Net(cfg["model"], lower=lower)
    tcfg = cfg["train"]
    lr, clip = float(tcfg["learning_rate"]), float(tcfg.get("clip_value", 0.0))
    p = {k: v.detach().clone().float().requires_grad_(True) for k, v in params.items()}
    names = list(p)
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator(device=device).manual_seed(dropout_seed)
    losses, first, count = [], None, 0
    with precision(tf32=lower and cfg["model"]["dtype"] != "bfloat16"):
        for batch in batches:
            loss = train_loss(cfg, net, p, batch, gen)
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if not all(bool(torch.isfinite(g).all()) for g in grads):
                    continue
                if clip > 0:
                    grads = [g.clamp(-clip, clip) for g in grads]
                if first is None:
                    first = {k: g.clone() for k, g in zip(names, grads)}
                count += 1
                for k, g in zip(names, grads):
                    mu[k] = ADAM_B1 * mu[k] + (1 - ADAM_B1) * g
                    nu[k] = ADAM_B2 * nu[k] + (1 - ADAM_B2) * g * g
                    m_hat = mu[k] / (1 - ADAM_B1 ** count)
                    v_hat = nu[k] / (1 - ADAM_B2 ** count)
                    p[k] -= lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return losses, first, {k: v.detach() for k, v in p.items()}


@torch.no_grad()
def eval_step(cfg: dict, params: dict, batch: dict, lower: bool = False):
    """→ (error triple (3,): mean ‖(sin yaw, x, y)‖, mean |sin yaw|, mean
    ‖(x, y)‖; the normalised mask (B, H, W))."""
    check_config(cfg)
    model = cfg["model"]
    net = Net(model, lower=lower)
    with precision(tf32=lower and model["dtype"] != "bfloat16"):
        scan = batch["loc_data"]
        mask = normalise_mask(net(params, scan["fft_data"]))
        cart = cartesian_mask(model, mask, scan["azimuths"])
        w = point_weights(cart, scan["raw_pc"], model["cart_resolution"],
                          model["cart_pixel_width"])
        T = icp_solve(model, batch, w)
    sin_yaw, trans = pose_errors(T)
    xi = torch.cat([sin_yaw[:, None], trans], dim=-1)
    err = torch.stack([torch.linalg.vector_norm(xi, dim=-1).mean(), sin_yaw.abs().mean(),
                       torch.linalg.vector_norm(trans, dim=-1).mean()])
    return err, mask
