"""Models of the port: `diffusion3d` (3-D heat diffusion, the reference's
headline), `hm3d` (hydro-mechanical porous flow, BASELINE config 4),
`wave2d` (the 2-D staggered acoustic wave, BASELINE config 3),
`shallow_water` (2-D linearized shallow water, config 3's other half, on
kernels generated from its `igg_torch.stencil` spec) and `stokes3d` (the
3-D staggered Stokes solver, BASELINE config 5)."""
