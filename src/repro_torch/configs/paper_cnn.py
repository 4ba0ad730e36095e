"""The paper's own local-client CNN (§III-B/§VI) + FL experiment defaults."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperCNNConfig:
    name: str = "paper-cnn"
    num_classes: int = 10
    image_size: int = 28
    channels: int = 1
    conv1: int = 32
    conv2: int = 64
    hidden: int = 128


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Paper §VI experiment constants."""
    num_clients: int = 100       # population N
    clients_per_round: int = 30  # n(s_T)
    global_epochs: int = 30      # T
    local_epochs: int = 4        # t
    batch_size: int = 32
    lr: float = 1e-3             # Adam (paper's optimizer)
    optimizer: str = "adam"
    selection: str = "labelwise"
    aggregation: str = "fedavg"  # fedavg | fedsgd
    server_lr: float = 1.0
    seed: int = 0


CONFIG = PaperCNNConfig()
FL = FLConfig()
