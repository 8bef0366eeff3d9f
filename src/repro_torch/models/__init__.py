"""Models: the toy MLP classifier (``toy``) and the LM stack for the
families ported so far (falcon-mamba: ``api``, ``lm``, ``blocks``,
``recurrent``, ``common``, ``attention``'s ``CacheSpec``)."""
