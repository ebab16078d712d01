from trackdlo_tpu_torch.io.sequence import SyntheticRope, render_frame, synthetic_sequence

__all__ = ["SyntheticRope", "render_frame", "synthetic_sequence"]
