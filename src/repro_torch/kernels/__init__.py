"""Hand-written CUDA kernels of the port, one subpackage per TPU kernel it
replaces, each with its plain PyTorch version in ``ref.py``."""


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name.  Each wrapper's
    ``launches`` counts its kernel's launches and nothing else; the pod
    route's bfloat16 and float16 launches are also counted apart (they are
    in ``fedavg_pod`` too)."""
    import torch

    from repro_torch.kernels.fedavg.kernel import (PodRoute, fedavg_flat, fedavg_pod_flat,
                                                   fedavg_wire_flat)
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.qpack import kernel as pk
    from repro_torch.kernels.qsync.kernel import adam_sync_flat, qsync_flat
    from repro_torch.kernels.ssd_scan.kernel import ssd_bthd
    return {"fedavg": fedavg_flat, "fedavg_wire": fedavg_wire_flat,
            "fedavg_pod": fedavg_pod_flat, "fedavg_pod_bf16": PodRoute(torch.bfloat16),
            "fedavg_pod_f16": PodRoute(torch.float16), "qsync": qsync_flat, "quant": pk.quant_flat,
            "dequant": pk.dequant_flat, "pack4": pk.pack4_flat,
            "unpack4": pk.unpack4_flat, "adam_sync": adam_sync_flat,
            "flash_attention": flash_attention_bhsd, "ssd_scan": ssd_bthd}
