"""Web-service transformers (counterpart of ``mmlspark_tpu/services/``,
after the reference's ``cognitive`` module): the ``ServiceParam``
scalar-or-column duality, request assembly over the port's
standard-library clients, async long-poll replies, and the service
families (text analytics, vision, face, anomaly detection, translation,
form recognition, search sinks, speech, multivariate anomaly detection,
geospatial). Host work, pointed at a configurable endpoint and tested
against local mock servers; ``SimpleDetectAnomalies`` without a ``url``
runs its median/MAD detector on the card.
"""

from .base import (HasServiceParams, ServiceParam, ServiceTransformer,
                   HasAsyncReply)
from .text import (EntityDetector, EntityDetectorSDK, Healthcare,
                   HealthcareSDK, KeyPhraseExtractor, KeyPhraseExtractorSDK,
                   LanguageDetector, LanguageDetectorSDK, NER, NERSDK, PII,
                   PIISDK, TextAnalyze, TextSentiment, TextSentimentSDK)
from .vision import (AnalyzeImage, DescribeImage, GenerateThumbnails, OCR,
                     ReadImage, RecognizeDomainSpecificContent,
                     RecognizeText, TagImage, flatten_ocr, flatten_read)
from .anomaly import DetectAnomalies, DetectLastAnomaly, SimpleDetectAnomalies
from .translate import (BreakSentence, DetectLanguage, DictionaryExamples,
                        DictionaryLookup, DocumentTranslator, Translate,
                        Transliterate)
from .face import (DetectFace, FindSimilarFace, GroupFaces, IdentifyFaces,
                   VerifyFaces)
from .form import (AnalyzeBusinessCards, AnalyzeCustomModel,
                   AnalyzeIDDocuments, AnalyzeInvoices, AnalyzeLayout,
                   AnalyzeReceipts, FormOntologyLearner,
                   FormOntologyTransformer, GetCustomModel, ListCustomModels,
                   flatten_document_results, flatten_model_list,
                   flatten_page_results, flatten_read_results)
from .search import AddDocuments, AzureSearchWriter, BingImageSearch
from .speech import (ConversationTranscription, SpeechToText,
                     SpeechToTextSDK, TextToSpeech)
from .mvad import DetectMultivariateAnomaly, FitMultivariateAnomaly
from .geospatial import (AddressGeocoder, CheckPointInPolygon,
                         ReverseAddressGeocoder)

__all__ = [
    "ServiceParam", "HasServiceParams", "ServiceTransformer", "HasAsyncReply",
    "TextSentiment", "LanguageDetector", "EntityDetector", "NER",
    "KeyPhraseExtractor", "PII", "TextAnalyze", "Healthcare",
    "TextSentimentSDK", "LanguageDetectorSDK", "EntityDetectorSDK", "NERSDK",
    "KeyPhraseExtractorSDK", "PIISDK", "HealthcareSDK",
    "AnalyzeImage", "OCR", "DescribeImage", "TagImage",
    "RecognizeText", "ReadImage", "GenerateThumbnails",
    "RecognizeDomainSpecificContent", "flatten_ocr", "flatten_read",
    "DetectLastAnomaly", "DetectAnomalies", "SimpleDetectAnomalies",
    "Translate", "Transliterate", "DetectLanguage", "BreakSentence",
    "DictionaryLookup", "DictionaryExamples",
    "DetectFace", "FindSimilarFace", "VerifyFaces", "GroupFaces",
    "IdentifyFaces",
    "AnalyzeLayout", "AnalyzeInvoices", "AnalyzeReceipts",
    "AnalyzeBusinessCards", "AnalyzeIDDocuments", "ListCustomModels",
    "GetCustomModel", "AnalyzeCustomModel", "flatten_read_results",
    "flatten_page_results", "flatten_document_results", "flatten_model_list",
    "AddDocuments", "AzureSearchWriter", "BingImageSearch",
    "DocumentTranslator", "FormOntologyLearner", "FormOntologyTransformer",
    "SpeechToText", "SpeechToTextSDK", "ConversationTranscription",
    "TextToSpeech",
    "FitMultivariateAnomaly", "DetectMultivariateAnomaly",
    "AddressGeocoder", "ReverseAddressGeocoder", "CheckPointInPolygon",
]
