"""Training: the clip loss, the optimizer and the train / validation steps
(port of ``dpvo_tpu/train``)."""

from dpvo_tpu_torch.train.loss import clip_loss, flow_error, pose_error  # noqa: F401
from dpvo_tpu_torch.train.step import make_optimizer, make_train_step, make_val_step  # noqa: F401
