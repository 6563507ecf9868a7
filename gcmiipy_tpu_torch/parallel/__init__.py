"""The decompositions over ``torch.distributed``: the latitude ring, the 2D
(lat x lon) mesh and the ensemble axis."""
