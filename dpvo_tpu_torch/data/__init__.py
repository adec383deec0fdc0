"""Data: synthetic clips, the TartanAir reader, augmentation and the
batcher; frame streams, file readers and RGB-D helpers (port of
``dpvo_tpu/data``)."""
