"""Device lanes and meshes (``context``) and the lane-by-lane collectives
of the LLM stack's mesh (``spmd``)."""
