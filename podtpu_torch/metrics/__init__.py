from podtpu_torch.metrics.map import (  # noqa: F401
    MeanAveragePrecision,
    mean_average_precision,
    metrics_per_class,
)
