from repro_torch.models.gan_nets import ACGANDiscriminator, ACGANGenerator
from repro_torch.models.transformer import Backbone

__all__ = ["ACGANGenerator", "ACGANDiscriminator", "Backbone"]
