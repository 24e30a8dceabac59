"""Models of the port: `diffusion3d` (3-D heat diffusion, the reference's
headline) and `hm3d` (hydro-mechanical porous flow, BASELINE config 4)."""
