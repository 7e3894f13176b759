"""Tools of the port, each runnable as
``python -m multiposenet_tpu_torch.tools.<name>``: the synthetic crowd
dataset, the COCO keypoint index builder, the torchvision ImageNet init,
the AP floor check, the eval ablation matrix and the synthetic end-to-end
gate; and the measurement tools (``benchlib`` holds what they share):
serving latency (``bench_serving``), the e2e stage split
(``bench_e2e_stages``), the reference-shaped baseline
(``bench_reference_shaped``), the trace profile (``profile_trace``), the
loader (``bench_loader``), the trainer loop (``bench_trainer_loop``),
training MFU (``bench_train_mfu``), the fold-BN A/B (``bench_fold_bn``)
and bf16 drift (``measure_bf16_drift``); the probe of the FPN's top
convolutions over a 1x1 map (``probe_pyramid_conv``); and the demo renders
(``make_demo``), the ResNet-101 synthetic recipe (``train_synth_e2e``), and
the real-data parity runbook (``real_parity_runbook``) with its verdict
(``diff_parity_metrics``)."""
