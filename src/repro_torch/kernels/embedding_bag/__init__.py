from repro_torch.kernels.embedding_bag.ops import (  # noqa: F401
    BagFormat,
    bag_launch,
    bag_plain,
    bag_sum,
    embedding_bag,
    embedding_bag_plain,
)
