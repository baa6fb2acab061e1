"""The counter's kernel charges on the card: ``python scripts/count_charges.py``.

Flash forward and backward in bf16 under ``launch.count.Counter``, at
TinyLlama's prefill shape and at a small one whose dK/dV split is 8 on
an H100: the backward runs on autograd's device thread, and its charge
must still reach the counting thread's counter. Each charge must equal
``_build.count_launch``'s launches, and the card's count the count on
``meta`` with the card's SM count (``Counter(sms=...)``). A launch on
another thread during a count must not be charged to it. Exits 1 on any
mismatch.
"""
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.launch import count  # noqa: E402

t0 = time.time()
_build.build_all()
print("build", round(time.time() - t0, 1), flush=True)
dev = torch.device("cuda")
sms = torch.cuda.get_device_properties(dev).multi_processor_count


def make(b, s, hq, hkv, d):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, s, h, d, generator=g).to(dev, torch.bfloat16)
            .requires_grad_(True) for h in (hq, hkv, hkv)]


def step(q, k, v):
    o = fo.flash_attention(q, k, v, True)
    o.float().sum().backward()
    return o


ok = True
for shape in ((2, 4096, 32, 4, 64), (1, 512, 8, 1, 64)):
    args = make(*shape)
    split = fo.dkdv_split(args[0], args[1])
    before = (fo.flash_attention.launches, fo.flash_attention_bwd.launches)
    card, _ = count.count_call(step, *args)
    torch.cuda.synchronize()
    launched = (fo.flash_attention.launches - before[0],
                fo.flash_attention_bwd.launches - before[1])
    meta, _ = count.count_call(step, *count.to_meta(args),
                               counter=count.Counter(sms=sms))
    charges = {k: v["calls"] for k, v in card["kernels"].items()}
    same = (card["bytes"] == meta["bytes"]
            and card["flops_by_dtype"] == meta["flops_by_dtype"]
            and card["kernels"] == meta["kernels"]
            and card["peak_live_bytes"] == meta["peak_live_bytes"])
    good = (same and charges == {"flash_attention": launched[0],
                                 "flash_attention_bwd": launched[1]}
            and launched == (1, 1))
    ok &= good
    print(shape, "split", split, "charges", charges, "launched", launched,
          "card", card["flops"], card["bytes"], card["peak_live_bytes"],
          "meta", meta["flops"], meta["bytes"], meta["peak_live_bytes"],
          "OK" if good else "FAIL", flush=True)

args = [t.detach() for t in make(2, 4096, 32, 4, 64)]
c = count.Counter()
with c:
    th = threading.Thread(target=fo.flash_attention, args=args)
    th.start()
    th.join()
torch.cuda.synchronize()
print("other thread charged:", c.summary()["kernels"], flush=True)
ok &= c.summary()["kernels"] == {}
print("ALL OK" if ok else "FAILED")
sys.exit(0 if ok else 1)
