"""The paper's own model (Section IV): CNN with two conv layers, two
max-pooling layers and two fully connected layers; ReLU activations and a
log-softmax head.  Twin of ``repro/configs/paper_cnn.py``.

Geometry follows the classic FedAvg MNIST CNN (McMahan et al. 2017, the
paper's ref [2]): conv 5x5x32 -> maxpool 2x2 -> conv 5x5x64 -> maxpool 2x2
-> fc 512 -> fc 10.  For Fashion-MNIST the paper says "hidden layer sizes
are larger": the FC layer is widened (1024).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    image_size: int = 28
    channels: int = 1
    conv1: int = 32
    conv2: int = 64
    kernel: int = 5
    fc: int = 512
    num_classes: int = 10


MNIST_CNN = CNNConfig()
FASHION_CNN = CNNConfig(fc=1024)
