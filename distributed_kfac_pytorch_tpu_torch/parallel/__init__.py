"""Distributed K-FAC over ``torch.distributed``: static work placement
(``placement``) and the KAISA strategies (``distributed``)."""
