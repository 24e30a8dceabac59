"""Models of the port: `diffusion3d` (3-D heat diffusion, the reference's
headline), `hm3d` (hydro-mechanical porous flow, BASELINE config 4) and
`wave2d` (the 2-D staggered acoustic wave, BASELINE config 3)."""
