"""Dataset and gate tools of the port, each runnable as
``python -m multiposenet_tpu_torch.tools.<name>``: the synthetic crowd
dataset, the COCO keypoint index builder, the torchvision ImageNet init,
the AP floor check, the eval ablation matrix and the synthetic end-to-end
gate."""
