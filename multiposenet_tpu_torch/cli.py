"""Command-line interface of the port — the counterpart of
``python -m multiposenet_tpu.cli``.

  python -m multiposenet_tpu_torch.cli train --subnet keypoint --coco-root /data/COCO
  python -m multiposenet_tpu_torch.cli val --subnet detection --ckpt <dir>
  python -m multiposenet_tpu_torch.cli test --ckpt <dir> --testdata ./demo/test_images
  python -m multiposenet_tpu_torch.cli coco-eval --ckpt <dir> --coco-root /data/COCO
  python -m multiposenet_tpu_torch.cli merge-results shard0.json shard1.json
  python -m multiposenet_tpu_torch.cli export-program pose.pt2 --ckpt <dir> --fold-bn
  python -m multiposenet_tpu_torch.cli bench
  python -m multiposenet_tpu_torch.cli export-torch <ckpt dir> out.h5
  python -m multiposenet_tpu_torch.cli import-torch ckpt.h5 <save dir>

Every command runs on the CUDA GPU; ``MPN_PLATFORM=cpu`` asks for the CPU
(the plain PyTorch twins of the kernels), as the JAX CLI's variable pins its
backend.  Without a GPU and without that request a command raises.
Checkpoints are the port's own directories (engine/checkpoint.py); ``--ckpt``
and ``--init-params`` load the model state partially, BatchNorm statistics
included.  ``main`` returns the command's result (the stats of ``coco-eval``
and ``merge-results``), so that it can also be called in process.

Several processes: ``train`` and ``coco-eval`` join a process group with
``--coordinator host:port --num-processes N --process-id I`` (one command
per process; ``MPN_DISTRIBUTED=1`` reads ``torchrun``'s environment
instead; parallel/distributed.py).  ``train``'s ``--batch-size`` is then the
global batch and each process loads its shard; ``coco-eval`` shards the
images by itself and process 0 scores them and writes the metrics file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _common(p: argparse.ArgumentParser):
    p.add_argument("--backbone", default="resnet101",
                   choices=["resnet50", "resnet101"])
    p.add_argument("--coco-root", default="/data/COCO/")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint directory (engine/checkpoint.py) to load")
    p.add_argument("--exp-name", default=None)
    p.add_argument("--inp-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--max-epoch", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--save-dir", default="./extra/models")
    p.add_argument("--bf16", action="store_true",
                   help="run conv/matmul activations in bfloat16 (autocast; "
                        "parameters stay float32)")


def _fold_flag(p: argparse.ArgumentParser):
    p.add_argument("--fold-bn", action="store_true",
                   help="fold the trunk BatchNorms into the convs before "
                        "them after the checkpoint load (inference-only "
                        "rewrite, models/fold_bn.py); outputs move by float "
                        "reassociation only")


def _cluster_flags(p: argparse.ArgumentParser):
    """Process-group membership, shared by ``train`` and ``coco-eval``."""
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (tcp://), or a URL such as "
                        "file:///shared/path; without it, MPN_DISTRIBUTED=1 "
                        "takes torchrun's environment")
    p.add_argument("--num-processes", type=int, default=None,
                   help="number of processes (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index (with --coordinator)")


def _join_cluster(args):
    """Join the process group the flags name (or none) and return this
    process's device."""
    from multiposenet_tpu_torch.parallel import distributed as pdist

    device = resolve_cli_device()
    pdist.initialize(args.coordinator, num_processes=args.num_processes,
                     process_id=args.process_id, device=device)
    return pdist.process_device() or device


def resolve_cli_device():
    """CUDA unless ``MPN_PLATFORM=cpu``; raises without a GPU."""
    import torch

    from multiposenet_tpu_torch.config import resolve_device
    plat = os.environ.get("MPN_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"MPN_PLATFORM={plat!r}: expected 'cpu' or 'cuda'")
    return resolve_device("cuda")


def build_config(args, subnet: str):
    import torch

    from multiposenet_tpu_torch.config import (
        Config, detection_train_config, keypoint_train_config,
        prn_train_config)
    cfg = {"keypoint": keypoint_train_config,
           "detection": detection_train_config,
           "prn": prn_train_config}.get(subnet, Config)()
    model = dataclasses.replace(cfg.model, backbone=args.backbone)
    if getattr(args, "bf16", False):
        model = dataclasses.replace(model, compute_dtype=torch.bfloat16)
    data = dataclasses.replace(
        cfg.data, coco_root=args.coco_root,
        json_path=os.path.join(args.coco_root, "COCO.json"),
        mask_dir=args.coco_root, num_workers=args.num_workers,
        **({"inp_size": args.inp_size} if args.inp_size else {}))
    tr = {}
    if args.exp_name:
        tr["exp_name"] = args.exp_name
    if args.batch_size:
        tr["batch_size"] = args.batch_size
    if args.lr:
        tr["init_lr"] = args.lr
    if args.max_epoch:
        tr["max_epoch"] = args.max_epoch
    tr["save_dir"] = args.save_dir
    tr["ckpt"] = args.ckpt
    train = dataclasses.replace(cfg.train, subnet=subnet or cfg.train.subnet,
                                **tr)
    # --inp-size also sets the eval base size (reference TestParams.inp_size,
    # tester.py:87: the multi-scale search scales off it)
    ev = (dataclasses.replace(cfg.eval, inp_size=args.inp_size)
          if args.inp_size else cfg.eval)
    return dataclasses.replace(cfg, model=model, data=data, train=train,
                               eval=ev)


def make_loaders(cfg, subnet: str, training: bool):
    from multiposenet_tpu_torch.data.coco_json import COCOIndex
    from multiposenet_tpu_torch.data.datasets import (
        DetectionDataset, KeypointDataset, PRNDataset,
        load_coco_json_index, split_keypoint_records)
    from multiposenet_tpu_torch.data.loader import Loader

    split = "train2017" if training else "val2017"
    ann = os.path.join(cfg.data.coco_root, "annotations",
                       f"person_keypoints_{split}.json")
    if subnet == "keypoint":
        records = load_coco_json_index(cfg.data.json_path)
        idx = split_keypoint_records(records, training)
        ds = KeypointDataset(records, idx, os.path.join(cfg.data.coco_root, "images"),
                             cfg.data.mask_dir, cfg.data, augment=training)
    elif subnet == "detection":
        coco = COCOIndex(ann)
        records = load_coco_json_index(cfg.data.json_path)
        img_ids = set(coco.get_img_ids())
        idx = [i for i, r in enumerate(records)
               if int(r["image_id"]) in img_ids]
        ds = DetectionDataset(records, idx, coco,
                              os.path.join(cfg.data.coco_root, split),
                              cfg.data, augment=training)
    else:  # prn
        ds = PRNDataset(COCOIndex(ann), cfg)
    # several processes: cfg.train.batch_size is the global batch, and each
    # process loads its disjoint shard; validation is sharded the same way,
    # and the val step averages over the processes, so every process's
    # plateau scheduler sees the same loss
    from multiposenet_tpu_torch.parallel import distributed as pdist
    return Loader(ds, pdist.per_host_batch(cfg.train.batch_size),
                  shuffle=training, num_workers=cfg.data.num_workers,
                  shard_id=pdist.process_index(),
                  num_shards=pdist.process_count())


def cmd_train(args):
    from multiposenet_tpu_torch.engine.trainer import Trainer
    from multiposenet_tpu_torch.parallel import distributed as pdist
    device = _join_cluster(args)
    try:
        cfg = build_config(args, args.subnet)
        train = make_loaders(cfg, args.subnet, True)
        val = make_loaders(cfg, args.subnet, False)
        Trainer(cfg, train_data=train, val_data=val,
                init_ckpt_params=args.init_params, device=device).train()
    finally:
        pdist.shutdown()


def cmd_val(args):
    from multiposenet_tpu_torch.engine.trainer import Trainer
    device = resolve_cli_device()
    cfg = build_config(args, args.subnet)
    val = make_loaders(cfg, args.subnet, False)
    return Trainer(cfg, train_data=None, val_data=val,
                   device=device).validate(args.max_batches)


def _load_eval(args, subnet="keypoint", device=None):
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.engine.evaluator import Evaluator
    from multiposenet_tpu_torch.models.fold_bn import fold_bn_state_dict
    from multiposenet_tpu_torch.models.posenet import build_posenet

    device = device or resolve_cli_device()
    cfg = build_config(args, subnet)
    model = build_posenet(cfg.model, device, seed=0)
    if args.ckpt:
        # the whole model state: weights AND BN running statistics
        # (reference load_net, net_utils.py:69-110)
        sd, _ = ckpt_lib.restore_model_state_partial(args.ckpt, model.state_dict())
        model.load_state_dict(sd)
    if getattr(args, "fold_bn", False):
        # restored into the unfolded graph first, then folded
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, fold_bn=True))
        model = build_posenet(cfg.model, device,
                              fold_bn_state_dict(model.state_dict()))
    return cfg, Evaluator(cfg, device=device, model=model)


def cmd_test(args):
    # validate inputs before the (slow) model build
    if not os.path.isdir(args.testdata):
        sys.exit(f"error: --testdata directory not found: {args.testdata}")
    _, ev = _load_eval(args)
    ev.cfg = dataclasses.replace(
        ev.cfg, eval=dataclasses.replace(ev.cfg.eval, write_image=True,
                                         write_json=True,
                                         testdata_dir=args.testdata,
                                         testresult_dir=args.testresult))
    results = ev.test()
    print(f"{len(results)} person instances detected")
    return results


def _apply_eval_flags(ev, args):
    updates = {}
    if args.host_resize:
        updates["device_resize"] = False
    if args.host_peaks:
        updates["device_peaks"] = False
    if args.host_image_resize:
        updates["device_image_resize"] = False
    if args.group_size is not None:
        updates["group_size"] = args.group_size
    if args.detect_all_scales:
        updates["detect_scale1_only"] = False
    if updates:
        ev.cfg = dataclasses.replace(
            ev.cfg, eval=dataclasses.replace(ev.cfg.eval, **updates))
    peaks_up, prn_up = {}, {}
    if args.max_peaks is not None:
        peaks_up["max_peaks_per_joint"] = args.max_peaks
    if args.max_people is not None:
        prn_up["max_people"] = args.max_people
    if args.no_escalate:
        peaks_up["escalate_max_peaks"] = 0
        prn_up["escalate_max_people"] = 0
    if args.no_refine:
        peaks_up["refine"] = False
    if args.host_grouping:
        prn_up["device_grouping"] = False
    if peaks_up:
        ev.cfg = dataclasses.replace(
            ev.cfg, peaks=dataclasses.replace(ev.cfg.peaks, **peaks_up))
    if prn_up:
        ev.cfg = dataclasses.replace(
            ev.cfg, prn=dataclasses.replace(ev.cfg.prn, **prn_up))


def cmd_coco_eval(args):
    from multiposenet_tpu_torch.parallel import distributed as pdist
    ann = os.path.join(args.coco_root, "annotations/person_keypoints_val2017.json")
    if not os.path.isfile(ann):
        sys.exit(f"error: annotations not found: {ann}")
    # join the group before the model is built; coco_eval then shards the
    # images per process and gathers the rows on process 0
    device = _join_cluster(args)
    try:
        return _coco_eval(args, device)
    finally:
        pdist.shutdown()


def _coco_eval(args, device):
    from multiposenet_tpu_torch.parallel import distributed as pdist
    if args.eval_shard and pdist.process_count() > 1:
        # a manual shard in a group would run the same slice in every
        # process and skip the rest
        sys.exit("error: --eval-shard conflicts with distributed mode; "
                 "in a process group each process shards by itself "
                 "(drop --eval-shard)")
    shard = (0, 1)
    if args.eval_shard:
        i, n = args.eval_shard.split(":")
        shard = (int(i), int(n))
        if not (0 <= shard[0] < shard[1]):
            sys.exit(f"error: bad --eval-shard {args.eval_shard}")
        if shard[1] > 1 and not args.result_file:
            sys.exit("error: --eval-shard requires --result-file "
                     "(merge shards with `cli merge-results`)")
    _, ev = _load_eval(args, device=device)
    _apply_eval_flags(ev, args)
    metrics = ev.coco_eval(max_images=args.max_images,
                           result_file=args.result_file, bucket=args.bucket,
                           shard=shard, skip_metrics=shard != (0, 1))
    if args.metrics_file and shard == (0, 1) and pdist.is_primary():
        # written whenever asked (an empty dict when nothing was detected),
        # so that a reader finds a definite verdict, not a missing file
        with open(args.metrics_file, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def cmd_export_program(args):
    """Export the whole pose pipeline, weights inside, as a serialized
    ``torch.export`` program (engine/export_model.py); serve it with
    ``BatchPredictor.from_exported``."""
    from multiposenet_tpu_torch.engine.export_model import export_pose_pipeline

    # an artifact of seed-0 weights would look valid and serve nonsense
    if not args.ckpt:
        sys.exit("error: export-program requires --ckpt (the artifact holds "
                 "the weights; exporting a random init is never what you want)")
    cfg, ev = _load_eval(args)
    batch = args.batch_size or 8
    blob = export_pose_pipeline(ev.model, cfg, batch, device=ev.device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, batch={batch}, "
          f"inp={cfg.eval.inp_size}")


def cmd_export_torch(args):
    """A port checkpoint in the reference's h5 layout
    (weights.write_reference_h5), loadable by the reference's load_net
    (net_utils.py:69-92); the counterpart of the JAX package's
    ``export-torch``."""
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.weights import write_reference_h5

    state = ckpt_lib.load_checkpoint(args.ckpt_dir)["model"]
    _check_backbone(state, args.backbone)
    write_reference_h5(state, args.out_h5, epoch=args.epoch)
    print(f"wrote {args.out_h5}: {len(state)} state_dict entries "
          f"(epoch={args.epoch})")


def cmd_import_torch(args):
    """A reference h5 checkpoint (weights.read_reference_h5) as a port
    model checkpoint under ``save_dir``, which ``--ckpt`` loads; the
    counterpart of tools/convert_torch_ckpt.py."""
    from multiposenet_tpu_torch.engine import checkpoint as ckpt_lib
    from multiposenet_tpu_torch.weights import read_reference_h5

    state, epoch = read_reference_h5(args.h5)
    _check_backbone(state, args.backbone)
    path = ckpt_lib.save_model_checkpoint(args.save_dir, state, max(epoch, 0))
    print(f"wrote {path}: {len(state)} state_dict entries (epoch={epoch})")
    return path


def _check_backbone(state, backbone: str) -> None:
    # resnet50 has 6 layer3 blocks, resnet101 23 (reference fpn.py:128-134)
    n_l3 = len({k.split(".")[2] for k in state if k.startswith("fpn.layer3.")})
    expect = {"resnet50": 6, "resnet101": 23}[backbone]
    if n_l3 != expect:
        sys.exit(f"error: the checkpoint has {n_l3} fpn.layer3 blocks but "
                 f"--backbone {backbone} has {expect}")


def cmd_bench(_args):
    from multiposenet_tpu_torch import bench
    return bench.main()


def cmd_merge_results(args):
    """Concatenate per-shard result files and run the OKS evaluation."""
    from multiposenet_tpu_torch.data.coco_json import COCOIndex
    from multiposenet_tpu_torch.eval.cocoeval import KeypointEval

    results = []
    for path in args.results:
        with open(path) as f:
            results.extend(json.load(f))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f)
    ann = os.path.join(args.coco_root,
                       "annotations/person_keypoints_val2017.json")
    gt = COCOIndex(ann)
    img_ids = gt.get_img_ids(cat_ids=[1])
    if args.max_images:
        img_ids = img_ids[:args.max_images]
    ev = KeypointEval(gt, gt.load_res(results), img_ids=img_ids)
    metrics = ev.evaluate()
    print(ev.summarize())
    return metrics


def main(argv=None):
    p = argparse.ArgumentParser("multiposenet_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train")
    _common(pt)
    pt.add_argument("--subnet", required=True,
                    choices=["keypoint", "detection", "prn"])
    pt.add_argument("--init-params", default=None,
                    help="another stage's checkpoint to start from (weights "
                         "and BN statistics)")
    _cluster_flags(pt)
    pt.set_defaults(fn=cmd_train)

    pv = sub.add_parser("val")
    _common(pv)
    pv.add_argument("--subnet", required=True,
                    choices=["keypoint", "detection", "prn"])
    pv.add_argument("--max-batches", type=int, default=1000000)
    pv.set_defaults(fn=cmd_val)

    pd = sub.add_parser("test")
    _common(pd)
    pd.add_argument("--testdata", default="./demo/test_images/")
    pd.add_argument("--testresult", default="./demo/output/")
    _fold_flag(pd)
    pd.set_defaults(fn=cmd_test)

    pc = sub.add_parser("coco-eval")
    _common(pc)
    pc.add_argument("--max-images", type=int, default=None)
    _fold_flag(pc)
    pc.add_argument("--result-file", default=None)
    pc.add_argument("--metrics-file", default=None,
                    help="write the 10-stat AP/AR summary as JSON")
    pc.add_argument("--bucket", type=int, default=64,
                    help="shape-bucketing granularity of the padded scales")
    pc.add_argument("--max-peaks", type=int, default=None,
                    help="base per-joint peak capacity "
                         "(cfg.peaks.max_peaks_per_joint)")
    pc.add_argument("--max-people", type=int, default=None,
                    help="base PRN person capacity (cfg.prn.max_people)")
    pc.add_argument("--no-escalate", action="store_true",
                    help="disable crowd-capacity escalation (saturated "
                         "images truncate with a warning instead of "
                         "re-dispatching at the escalated tier)")
    pc.add_argument("--no-refine", action="store_true",
                    help="disable sub-pixel peak refinement (cfg.peaks.refine)")
    pc.add_argument("--host-resize", action="store_true",
                    help="resize/average multi-scale heatmaps on the host "
                         "(reference-exact chain) instead of the cv2-matching "
                         "on-device matmul path")
    pc.add_argument("--host-peaks", action="store_true",
                    help="fetch the averaged heatmap and find peaks on the "
                         "host (reference y-major peak order) instead of on "
                         "device after the fold")
    pc.add_argument("--host-image-resize", action="store_true",
                    help="build the multi-scale image pyramid with host "
                         "resizes (one upload per scale) instead of on device "
                         "from one uploaded original")
    pc.add_argument("--group-size", type=int, default=None,
                    help="batch up to N same-bucket images per device "
                         "dispatch (1 = per-image)")
    pc.add_argument("--detect-all-scales", action="store_true",
                    help="run the RetinaNet branch on every scale (the "
                         "reference-shaped per-scale box lists) instead of "
                         "scale 1.0 only — results are identical; boxes from "
                         "other scales are never consumed (tester.py:169)")
    pc.add_argument("--host-grouping", action="store_true",
                    help="run the greedy mutual-best assignment on host "
                         "(reference-exact twin) instead of on device")
    pc.add_argument("--eval-shard", default=None, metavar="I:N",
                    help="process only image slice i::n (then `cli "
                         "merge-results`)")
    _cluster_flags(pc)
    pc.set_defaults(fn=cmd_coco_eval)

    pm = sub.add_parser("merge-results")
    pm.add_argument("results", nargs="+",
                    help="per-shard result json files from coco-eval")
    pm.add_argument("--coco-root", default="/data/COCO/")
    pm.add_argument("--max-images", type=int, default=None)
    pm.add_argument("--out", default=None, help="write merged json here")
    pm.set_defaults(fn=cmd_merge_results)

    pe = sub.add_parser(
        "export-program",
        help="export the whole pose pipeline (weights inside) as a "
             "torch.export program; serve it with "
             "BatchPredictor.from_exported")
    _common(pe)
    pe.add_argument("out", help="output artifact path")
    _fold_flag(pe)
    pe.set_defaults(fn=cmd_export_program)

    px = sub.add_parser(
        "export-torch",
        help="write a checkpoint in the reference PyTorch h5 layout")
    px.add_argument("ckpt_dir", help="a checkpoint directory of the port")
    px.add_argument("out_h5")
    px.add_argument("--backbone", default="resnet101",
                    choices=["resnet50", "resnet101"])
    px.add_argument("--epoch", type=int, default=-1)
    px.set_defaults(fn=cmd_export_torch)

    pi = sub.add_parser(
        "import-torch",
        help="read a reference PyTorch h5 checkpoint into a checkpoint of "
             "the port (for --ckpt)")
    pi.add_argument("h5")
    pi.add_argument("save_dir", help="the checkpoint is written as "
                                     "<save_dir>/ckpt_<epoch>")
    pi.add_argument("--backbone", default="resnet101",
                    choices=["resnet50", "resnet101"])
    pi.set_defaults(fn=cmd_import_torch)

    pb = sub.add_parser("bench", help="the e2e serving benchmark (bench.py's "
                                      "configuration) on the GPU")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
