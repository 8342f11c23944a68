"""Point-cloud ops.  Each op with a kernel is a ``torch.library`` custom op
with a ``"cpu"`` kernel (its plain PyTorch version), a ``"cuda"`` kernel
(the hand-written kernel's wrapper) and a fake implementation that gives
the output shapes: PyTorch's dispatcher picks the kernel by the device of
the inputs, and ``torch.export`` traces the op through its fake.
Importing this package registers all seven (F-FPS's among them), and ``interpolate``'s
``three_nn`` (a plain PyTorch op on every device; see
``cuda_lib.NAMESPACE``)."""

from . import attention, ball_query, interpolate, nms, rotated_iou, sampling  # noqa: F401
