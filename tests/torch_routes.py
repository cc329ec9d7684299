"""Spies on the port's kernel wrappers, for tests that show which route a
model's steps took: the fused steps (FFN step, attention step) or the
unfused route's kernels (FFN core #8, flash attention #6).  On the CPU each
wrapper runs its plain version, so a spy's count is the number of calls the
card would have launched."""

from mss_tf_locoformer_tpu_torch.nn import attention as nn_attention
from mss_tf_locoformer_tpu_torch.nn import ffn as nn_ffn
from mss_tf_locoformer_tpu_torch.ops.cuda import flash_attention as FA
from mss_tf_locoformer_tpu_torch.ops.cuda import swiglu_ffn as SF

FUSED_STEPS = ((nn_ffn, "fused_norm_ffn_residual"),
               (nn_attention, "fused_attention_block"))
UNFUSED_KERNELS = ((SF, "swiglu_conv_deconv"), (FA, "flash_attention"))


def spy(monkeypatch, targets=FUSED_STEPS + UNFUSED_KERNELS):
    """Wrap each ``(module, name)`` so that its calls are counted; returns
    the dict of counts by name (0 until called)."""
    calls = {name: 0 for _, name in targets}
    for module, name in targets:
        real = getattr(module, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return calls
