"""Vision models of the port: detection pre/post-processing, cover-crop
geometry, the blaze stand-in nets and the batched inference runner."""
