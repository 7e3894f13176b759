"""The benchmark's frozen plain-PyTorch reference of MultiPoseNet: the
model (``model.py``), the serving pipeline after the forward (``post.py``),
the detection stage's train step (``train.py``) and FLOP counts
(``flops.py``).  It imports nothing of the program."""
