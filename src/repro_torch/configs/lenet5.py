"""The paper's own architecture: LeNet-5 (Keras variant, Fig. 3) with the
hybrid stochastic-binary first layer."""
from repro_torch.core.sc_layer import SCConfig
from repro_torch.models.lenet import LeNetConfig


def config() -> LeNetConfig:
    return LeNetConfig()


def sc_config(bits: int = 4) -> SCConfig:
    return SCConfig(bits=bits, scheme="ramp_lowdisc", adder="tff")


def smoke_config() -> LeNetConfig:
    return LeNetConfig(conv1_filters=8, conv2_filters=8, dense=32)
