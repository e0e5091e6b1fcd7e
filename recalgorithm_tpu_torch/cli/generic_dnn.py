"""CLI alias: `python -m recalgorithm_tpu_torch.cli.generic_dnn` trains GenericDNN
(``cli.main`` with ``--model GenericDNN`` preset; every flag of ``cli.main``)."""

from recalgorithm_tpu_torch.cli.main import main

if __name__ == "__main__":
    main(model_name="GenericDNN")
