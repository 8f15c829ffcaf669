from video_analytics_tpu_torch.cli.main import main  # noqa: F401
