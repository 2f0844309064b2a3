from gaunegf_tpu_torch.utils.logging import get_logger, perf_span, profile_trace  # noqa: F401
