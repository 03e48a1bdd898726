"""What is attached: the counterpart of shmgan_tpu/utils/device.py, through
torch.cuda. Each visible card's id, name, this process's rank, the card's
memory and what this process's tensors hold on it. Reading the properties
creates no CUDA context on a card this process does not use.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from shmgan_tpu_torch.parallel.mesh import rank, world_size


def device_report() -> Dict:
    rows: List[Dict] = []
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(count):
        props = torch.cuda.get_device_properties(i)
        rows.append({
            "id": i,
            "platform": "gpu",
            "kind": props.name,
            "process": rank(),
            "hbm_limit_gb": round(props.total_memory / 2 ** 30, 2),
            "hbm_in_use_mb": round(torch.cuda.memory_allocated(i) / 2 ** 20, 1),
        })
    return {
        "backend": "cuda" if count else "cpu",
        "device_count": count,
        "process_index": rank(),
        "process_count": world_size(),
        "devices": rows,
    }


def print_device_report() -> None:
    rep = device_report()
    print(f"[devices] backend={rep['backend']} count={rep['device_count']} "
          f"rank={rep['process_index']} processes={rep['process_count']}", flush=True)
    for d in rep["devices"]:
        print(f"  - #{d['id']} {d['kind']} ({d['platform']}) rank={d['process']} "
              f"hbm={d['hbm_limit_gb']}GB in_use={d['hbm_in_use_mb']}MB", flush=True)
