"""Training data: synthetic clips, augmentation and the batcher (port of
``dpvo_tpu/data``'s factory and augmentation; the TartanAir reader is not
ported yet)."""
