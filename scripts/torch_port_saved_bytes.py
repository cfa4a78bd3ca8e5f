#!/usr/bin/env python3
"""What a train-mode forward of the port's image models keeps for the
backward, per image, counted on the CPU.

    python3 scripts/torch_port_saved_bytes.py [--batch 2]

For ResNet-50 (224×224), Inception-V3 (299×299) and VGG-16 (224×224),
bf16 activations and 1000 classes as ``bench.py`` builds them, runs one
forward under ``torch.autograd.graph.saved_tensors_hooks`` and prints
the bytes of the distinct storages autograd saves, and the elements the
BatchNorm layers output, each divided by the batch.  These are counts,
not device measurements: they size a chip run's peak memory and the
bytes BatchNorm's passes move before the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count(model, side: int, batch: int) -> dict:
    import torch
    from horovod_tpu_torch.models.resnet import BatchNorm

    storages = {}
    bn_elems = []

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = \
            t.untyped_storage().nbytes()
        return t

    hooks = [m.register_forward_hook(
        lambda mod, args, out: bn_elems.append(out.numel()))
        for m in model.modules() if isinstance(m, BatchNorm)]
    x = torch.randn(batch, side, side, 3).bfloat16()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x)
    for h in hooks:
        h.remove()
    return dict(saved_bytes_per_image=sum(storages.values()) / batch,
                batchnorm_elements_per_image=sum(bn_elems) / batch,
                params=sum(p.numel() for p in model.parameters()))


def main() -> int:
    import torch
    import horovod_tpu_torch as hvd

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=2)
    args = parser.parse_args()
    kw = dict(num_classes=1000, dtype=torch.bfloat16, device="cpu")
    out = {
        "resnet50": count(hvd.models.ResNet50(**kw), 224, args.batch),
        "inception3": count(hvd.models.InceptionV3(**kw), 299, args.batch),
        "vgg16": count(hvd.models.VGG16(**kw), 224, args.batch),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
