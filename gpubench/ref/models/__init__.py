"""The reference's models: cover-crop geometry, the face mesh graph and
its executor, the blaze stand-in and the landmark runner."""
