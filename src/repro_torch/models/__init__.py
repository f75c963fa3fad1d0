from repro_torch.models.gan_nets import ACGANDiscriminator, ACGANGenerator

__all__ = ["ACGANGenerator", "ACGANDiscriminator"]
