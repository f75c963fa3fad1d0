from repro_torch.models.adversarial import AdversarialLM, FeatureDiscriminator
from repro_torch.models.gan_nets import (ACGANDiscriminator, ACGANGenerator,
                                        CGAN1DDiscriminator, CGAN1DGenerator,
                                        MLPDiscriminator, MLPGenerator,
                                        Toy2DDiscriminator, Toy2DGenerator)
from repro_torch.models.transformer import Backbone

__all__ = ["Toy2DGenerator", "Toy2DDiscriminator", "MLPGenerator",
           "MLPDiscriminator", "ACGANGenerator", "ACGANDiscriminator",
           "CGAN1DGenerator", "CGAN1DDiscriminator", "Backbone", "AdversarialLM",
           "FeatureDiscriminator"]
