"""Models: the toy MLP classifier (``toy``) and the LM stack for the
families ported so far, falcon-mamba and recurrentgemma (``api``, ``lm``,
``blocks``, ``recurrent``, ``attention``, ``mlp``, ``common``)."""
