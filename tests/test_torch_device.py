"""The port's entry points build on the card unless the caller names a
device: with no card and no ``device`` they raise ``NoCardError`` before
building anything, and ``device="cpu"`` builds on the CPU.  The card's
absence is simulated with ``torch.cuda.is_available`` patched to False, so
these tests run the same with or without a card."""
import pytest
import torch

from pyvbmp_tpu_torch import models as tm
from pyvbmp_tpu_torch import transforms as tt
from pyvbmp_tpu_torch.dists import GMM_vector, NormalInverseWishart
from pyvbmp_tpu_torch.dists.mvn_ard import MVN_ard
from pyvbmp_tpu_torch.transforms import MatrixNormalWishart
from pyvbmp_tpu_torch.utils import convert
from pyvbmp_tpu_torch.utils.torchutils import NoCardError, default_device

DHMM_OBS = NormalInverseWishart.create((2,), (3,), generator=torch.Generator().manual_seed(0))
# the tensor HMMs' observations (state axes (2, 3)) and an LDS's pad_X
# observation model, built before the calls as for an HMM
TENSOR_OBS = NormalInverseWishart.create((2,), (2, 3),
                                         generator=torch.Generator().manual_seed(0))
LDS_OBS = tt.MatrixNormalGamma.create((3, 2), pad_X=True,
                                      generator=torch.Generator().manual_seed(0))
CONSTRUCTORS = {
    "DMBD": lambda **k: tm.DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2), **k),
    "DMBD 3 objects": lambda **k: tm.DynamicMarkovBlanketDiscovery(
        (5, 4), (2, 2, 2), (2, 2, 2), number_of_objects=3, **k),
    "DMBD unique_obs": lambda **k: tm.DynamicMarkovBlanketDiscovery(
        (3, 2), (1, 2, 1), (2, 2, 2), unique_obs=True, **k),
    "LDS": lambda **k: tm.LinearDynamicalSystems((3,), 2, **k),
    "MixLDS": lambda **k: tm.MixtureofLinearDynamicalSystems(2, (3,), 2, 0, 0, **k),
    "ARHMM_prXRY": lambda **k: tm.ARHMM_prXRY(3, 2, 4, 1, **k),
    "ARHMM": lambda **k: tm.ARHMM(3, 2, 2, **k),
    "ARHMM_prXY": lambda **k: tm.ARHMM_prXY(3, 2, 2, **k),
    # the observation model is built before the call, as for an HMM
    "dHMM": lambda **k: tm.dHMM(DHMM_OBS, 2, **k),
    "NLDS": lambda **k: tm.NLDS((3,), 2, 2, **k),
    "LDS pad_X obs_model": lambda **k: tm.LinearDynamicalSystems((3,), 2, obs_model=LDS_OBS,
                                                                  **k),
    "Tensor_HMM": lambda **k: tm.Tensor_HMM(TENSOR_OBS, (2, 3), **k),
    "HHMM": lambda **k: tm.HHMM(TENSOR_OBS, event_dim=2, **k),
    "Factorial_HMM": lambda **k: tm.Factorial_HMM(3, (2,), (4,), **k),
    "GMM_vector": lambda **k: GMM_vector(4, 3, **k),
    "GMM": lambda **k: tm.GaussianMixtureModel(4, 3, **k),
    "GMM isotropic": lambda **k: tm.GaussianMixtureModel(4, 3, isotropic=True, **k),
    "PoissonMixture": lambda **k: tm.PoissonMixtureModel(4, 3, **k),
    "MNLR": lambda **k: tt.MultiNomialLogisticRegression(3, 4, **k),
    "MNLR (Bouchard)": lambda **k: tt.MultiNomialLogisticRegression_Bouchard(3, 4, **k),
    "dMixLT": lambda **k: tt.dMixtureofLinearTransforms(3, 4, 2, **k),
    "NLR-multinomial": lambda **k: tt.NLRegression_Multinomial(3, 4, 2, **k),
}
NODES = (NormalInverseWishart, MatrixNormalWishart, MVN_ard)
# converter name -> the state of a small CPU model
CONVERTERS = {
    "dmbd": lambda: convert.dmbd_state(CONSTRUCTORS["DMBD"](device="cpu")),
    "hmm": lambda: convert.hmm_state(tm.HMM(
        NormalInverseWishart.create((2,), (3,), generator=torch.Generator().manual_seed(0)),
        device="cpu")),
    "lds": lambda: convert.lds_state(CONSTRUCTORS["LDS"](device="cpu")),
    "mixlds": lambda: convert.mixlds_state(CONSTRUCTORS["MixLDS"](device="cpu")),
    "arhmm": lambda: convert.arhmm_state(CONSTRUCTORS["ARHMM"](device="cpu")),
    "dhmm": lambda: convert.dhmm_state(CONSTRUCTORS["dHMM"](device="cpu")),
    "nlds": lambda: convert.nlds_state(CONSTRUCTORS["NLDS"](device="cpu")),
    "gmm": lambda: convert.gmm_state(CONSTRUCTORS["GMM"](device="cpu")),
    "tensor_hmm": lambda: convert.tensor_hmm_state(CONSTRUCTORS["HHMM"](device="cpu")),
    "mvn_ard": lambda: convert.mvn_ard_state(
        MVN_ard.create(event_shape=(2, 3, 1), generator=torch.Generator().manual_seed(0))),
    "mnlr": lambda: convert.mnlr_state(CONSTRUCTORS["MNLR"](device="cpu")),
    "bouchard": lambda: convert.bouchard_state(CONSTRUCTORS["MNLR (Bouchard)"](device="cpu")),
    "dmixlt": lambda: convert.dmixlt_state(CONSTRUCTORS["dMixLT"](device="cpu")),
    "nlrm": lambda: convert.nlrm_state(CONSTRUCTORS["NLR-multinomial"](device="cpu")),
}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def nothing_built(monkeypatch):
    """Counts calls of the node constructors the entry points start from:
    the latent prior, the emission and expert weights, the ARD weights."""
    built = []
    for cls in NODES:
        create = cls.create
        monkeypatch.setattr(cls, "create",
                            lambda *a, _c=create, **k: built.append(1) or _c(*a, **k))
    return built


def tensors(obj, seen=None):
    """Every tensor reachable from ``obj`` through attributes and fields."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v, seen)
    elif hasattr(obj, "__dict__"):
        for v in vars(obj).values():
            yield from tensors(v, seen)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_default_device_raises_without_a_card(no_card):
    with pytest.raises(NoCardError, match="device='cpu'"):
        default_device()
    assert default_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_without_a_device_raises_with_no_card(no_card, nothing_built, name):
    with pytest.raises(NoCardError):
        CONSTRUCTORS[name](generator=torch.Generator().manual_seed(0))
    assert nothing_built == []


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_on_the_cpu_when_asked(no_card, name):
    m = CONSTRUCTORS[name](generator=torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float64)
    ts = list(tensors(m))
    assert ts and all(t.device.type == "cpu" for t in ts)


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_from_state_without_a_device_raises_with_no_card(monkeypatch, name):
    state = CONVERTERS[name]()
    from_state = getattr(convert, f"{name}_from_state")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    for cls in NODES:
        monkeypatch.setattr(cls, "create", lambda *a, **k: built.append(1))
    with pytest.raises(NoCardError):
        from_state(state, dtype=torch.float32)
    assert built == []
    monkeypatch.undo()
    m = from_state(state, "cpu", torch.float32)
    ts = [t for t in tensors(m) if t.is_floating_point()]
    assert ts and all(t.device.type == "cpu" and t.dtype == torch.float32 for t in ts)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_without_a_device_builds_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = CONSTRUCTORS[name](generator=torch.Generator().manual_seed(0))
    ts = list(tensors(m))
    assert ts and all(t.device.type == "cuda" for t in ts)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONVERTERS))
def test_from_state_without_a_device_builds_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    m = getattr(convert, f"{name}_from_state")(CONVERTERS[name](), dtype=torch.float32)
    ts = [t for t in tensors(m) if t.is_floating_point()]
    assert ts and all(t.device.type == "cuda" and t.dtype == torch.float32 for t in ts)
