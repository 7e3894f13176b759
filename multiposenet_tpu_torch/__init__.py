"""multiposenet_tpu_torch — MultiPoseNet in PyTorch and CUDA: serving,
multi-scale COCO evaluation and three-stage training.

A port of the JAX package ``multiposenet_tpu`` to PyTorch on an NVIDIA
Hopper GPU.  The module layout mirrors the JAX package so each function has
a counterpart under the same path:

  config.py            configuration dataclasses (torch dtypes)
  weights.py           Flax {params, batch_stats} tree -> torch state_dict
  models/              ResNet-FPN, keypoint head, RetinaNet heads, PRN
  ops/                 anchors, boxes, NMS (+ the CUDA suppression kernel),
                       peaks, gaussian blur, heatmap targets, losses,
                       device grouping, pyramid and resize operators
  data/                COCO index, PRN dataset, loader, device prefetch
  eval/                COCO keypoint eval, grouping, multi-scale helpers
  engine/inference.py  the end-to-end pose pipeline
  engine/predictor.py  BatchPredictor, the serving front
  engine/evaluator.py  Evaluator, the multi-scale COCO eval
  engine/train_steps.py, trainer.py, checkpoint.py   training
  parallel/            several processes (torch.distributed) and the
                       devices of one process (Mesh, sharded serving)
  utils/               meters, timer, logger, metrics log, profiler window
  tools/               the synthetic dataset, the COCO index builder, the
                       ImageNet init, the synthetic end-to-end AP gate

Public tensors keep the JAX package's layouts (NHWC images, (B, H/4, W/4, 18)
heatmaps, (B, A, 1) / (B, A, 4) detection heads in (y, x, anchor) order), so
the two packages compare like with like.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
