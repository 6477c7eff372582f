"""CIFAR ResNet in PyTorch (the ZeRO-0, one-card rung).

Counterpart of ``deepspeed_tpu/models/resnet.py``: ``depth = 6n + 2``, three
stages of ``n`` basic blocks at ``width``, ``2 width`` and ``4 width``
channels (the last two open with a stride-2 block), global average pooling
and a linear head.  Images come in NHWC ``[B, H, W, 3]``, as in JAX; the
convolutions run on a channels-last view of them.

As in JAX:

* convolutions pad as XLA's ``"SAME"``: a stride-2 3 x 3 convolution of an
  even input pads 0 before and 1 after (``nn.Conv2d(padding=1)`` would pad
  1 on each side and shift every window by a pixel), so the padding is an
  explicit :func:`F.pad` by :func:`same_padding`;
* BatchNorm uses the batch's statistics (fp32, population variance) and
  keeps no running averages (JAX's documented deviation), the normalised
  value cast to the compute dtype before its scale and shift;
* a block whose channels change projects its input by a 1 x 1 stride-2
  convolution; a stride-2 block that keeps them (none at 6n + 2) takes
  every other pixel.

Conv weights are stored ``[out, in, kh, kw]`` (JAX keeps ``[kh, kw, in,
out]``; ``models/convert.py`` maps them) in ``config.param_dtype`` and read
through ``runtime/zero/sharder.compute_weight``.  Everything is plain
PyTorch (cuDNN convolutions): the JAX model has no Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import AXIS_TENSOR, ProcessMesh
from ..runtime.zero.init_ctx import active as zero_init_active
from ..runtime.zero.init_ctx import materialize
from ..runtime.zero.sharder import compute_weight
from ..utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 56                 # 6n+2; n blocks per stage
    num_classes: int = 10
    width: int = 16                 # stage-1 channels (then 2x, 4x)
    image_size: int = 32
    dtype: torch.dtype = torch.bfloat16
    #: storage dtype of the weights (None: ``dtype``)
    param_dtype: Optional[torch.dtype] = None

    @property
    def blocks_per_stage(self) -> int:
        if (self.depth - 2) % 6:
            raise ValueError("depth must be 6n+2 (20, 32, 44, 56, 110, ...)")
        return (self.depth - 2) // 6

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    @classmethod
    def resnet56(cls, **kw) -> "ResNetConfig":
        return cls(depth=56, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetConfig":
        d = dict(depth=8, width=8, image_size=8)
        d.update(kw)
        return cls(**d)

    def num_params(self) -> int:
        n = self.blocks_per_stage
        w = self.width
        total = 3 * 3 * 3 * w + 2 * w                      # stem
        for s, c in enumerate((w, 2 * w, 4 * w)):
            cin = w if s == 0 else c // 2
            total += (9 * cin * c + 9 * c * c + 4 * c      # first block
                      + (cin != c) * cin * c)
            total += (n - 1) * (18 * c * c + 4 * c)        # rest
        return total + 4 * w * self.num_classes + self.num_classes


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(before, after)`` so
    that the output has ``ceil(size / stride)`` positions; the odd pixel
    goes after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW convolution with ``"SAME"`` padding; ``w [out, in, kh, kw]``
    already in x's dtype."""
    kh, kw = w.shape[-2:]
    top, bottom = same_padding(x.shape[-2], kh, stride)
    left, right = same_padding(x.shape[-1], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride)


def _bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    """Batch-statistics norm over (N, H, W) of NCHW: fp32 mean and
    population variance, cast to x's dtype, then ``* scale + bias`` in it."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=(0, 2, 3), keepdim=True)
    var = x32.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    shape = (1, -1, 1, 1)
    return (((x32 - mu) * torch.rsqrt(var + eps)).to(dt)
            * compute_weight(scale, dt).view(shape)
            + compute_weight(bias, dt).view(shape))


def _param(shape: Sequence[int], dtype: torch.dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta", dtype=dtype))


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with batch-statistics norms, and the 1 x 1
    projection when the channels change."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        self.conv1 = _param((cout, cin, 3, 3), dtype)
        self.conv2 = _param((cout, cout, 3, 3), dtype)
        self.bn1_s, self.bn1_b = _param((cout,), dtype), _param((cout,), dtype)
        self.bn2_s, self.bn2_b = _param((cout,), dtype), _param((cout,), dtype)
        self.proj = _param((cout, cin, 1, 1), dtype) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = _conv(x, compute_weight(self.conv1, dt), self.stride)
        h = F.relu(_bn(h, self.bn1_s, self.bn1_b))
        h = _bn(_conv(h, compute_weight(self.conv2, dt)), self.bn2_s,
                self.bn2_b)
        if self.proj is not None:
            x = _conv(x, compute_weight(self.proj, dt), self.stride)
        elif self.stride != 1:
            x = x[:, :, ::self.stride, ::self.stride]
        return F.relu(x + h)


class ResNetModel(nn.Module):
    """CIFAR ResNet.  ``device`` defaults to ``"cuda"`` and raises without
    a CUDA device; weights are drawn from a ``torch.Generator`` seeded with
    ``seed``.  On a mesh whose ``tensor`` axis is above 1 (``mesh=``, or
    :meth:`shard_`) every leaf stays whole (JAX ``param_specs``
    :151-154: the convolutions are small): the tensor ranks compute the
    same step on the same rows, and their gradients come out equal with
    no sum over ``tensor``."""

    #: trains on a mesh whose ``tensor`` axis is above 1
    tensor_parallel_training = True

    def __init__(self, config: ResNetConfig, device: DeviceLike = "cuda",
                 seed: int = 0, mesh: Optional[ProcessMesh] = None):
        super().__init__()
        dev = resolve_device(device)
        self.config = c = config
        self.tp, self.tp_rank, self.mesh = 1, 0, None
        if mesh is not None:
            self.shard_(mesh)
        n, w, dt = c.blocks_per_stage, c.width, c.storage_dtype
        self.stem_conv = _param((w, 3, 3, 3), dt)
        self.stem_bn_s, self.stem_bn_b = _param((w,), dt), _param((w,), dt)
        stages: List[nn.ModuleList] = []
        for cin, cout, stride in ((w, w, 1), (w, 2 * w, 2),
                                  (2 * w, 4 * w, 2)):
            stages.append(nn.ModuleList(
                [BasicBlock(cin, cout, stride, dt)]
                + [BasicBlock(cout, cout, 1, dt) for _ in range(n - 1)]))
        self.stages = nn.ModuleList(stages)
        self.head = nn.Linear(4 * w, c.num_classes, device="meta", dtype=dt)
        if zero_init_active() is None:
            self.to_empty(device=dev)
        self.init_params(seed, dev)

    def shard_(self, mesh: ProcessMesh) -> "ResNetModel":
        """Take ``mesh``'s tensor axis; no leaf is split."""
        if self.tp != 1:
            raise ValueError(f"the model is already on {self.tp} tensor "
                             "ranks")
        self.mesh = mesh
        self.tp = int(mesh.shape[AXIS_TENSOR])
        self.tp_rank = mesh.axis_rank(AXIS_TENSOR) if self.tp > 1 else 0
        return self

    @property
    def device(self) -> torch.device:
        return self.stem_bn_s.device

    @torch.no_grad()
    def init_params(self, seed: int = 0,
                    device: Optional[torch.device] = None) -> None:
        """He init as JAX: each conv ``N(0, 2 / (kh kw cin))``, the head
        ``N(0, 2 / 4w)``, norms' scales 1, shifts and the head's bias 0,
        drawn in fp32 from a generator seeded with ``seed``."""
        dev = device if device is not None else self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() > 1:
                fan_in = p[0].numel()
                full = torch.randn(p.shape, generator=gen, device=dev,
                                   dtype=torch.float32).mul_(
                                       math.sqrt(2.0 / fan_in))
                materialize(p, dev, lambda t, f=full: t.copy_(f))
            else:
                value = 1.0 if name.endswith("_s") else 0.0
                materialize(p, dev, lambda t, v=value: t.fill_(v))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` images → ``[B, num_classes]`` fp32 logits."""
        dt = self.config.dtype
        x = images.to(dt).permute(0, 3, 1, 2)  # NCHW view, channels last
        x = F.relu(_bn(_conv(x, compute_weight(self.stem_conv, dt)),
                       self.stem_bn_s, self.stem_bn_b))
        for stage in self.stages:
            for block in stage:
                x = block(x)
        x = x.mean(dim=(2, 3))  # global average pool
        logits = (F.linear(x, compute_weight(self.head.weight, dt))
                  + compute_weight(self.head.bias, dt))
        return logits.float()

    def loss(self, batch: Any) -> torch.Tensor:
        """Softmax cross entropy over ``{"images", "labels"}`` (or
        ``{"input_ids", "labels"}``, the images under the engine's key)."""
        images = batch.get("images", batch.get("input_ids"))
        logp = torch.log_softmax(self.forward(images), dim=-1)
        return -logp.gather(-1, batch["labels"].long()[:, None])[:, 0].mean()
