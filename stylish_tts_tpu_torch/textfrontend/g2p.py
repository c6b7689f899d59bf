"""Grapheme-to-phoneme conversion producing espeak-flavoured IPA matching
the 178-symbol training inventory.

Capability parity with the reference phonemes module (lib/ttab/phonemes.py),
which drives external espeak-ng through `phonemizer` plus a lexicon and
IPA fix-ups.  Air-gapped pods have no espeak, so this module provides:
  * a built-in lexicon of frequent/irregular English words,
  * context-sensitive letter-to-sound rules for everything else,
  * espeak-convention IPA post-fixes (length marks, affricate spelling,
    stress placed before the syllable onset),
  * plural/possessive inflection in phoneme space.

An external `espeak-ng` binary is used automatically when present.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import List, Optional

VOWELS = "iyɪeʏøɛæœaɨɘʉəɜɵɐɞʊɯɤʌɑuoɔɒː"

LEXICON = {
    "a": "ɐ", "an": "ɐn", "the": "ðə", "and": "ænd", "of": "ʌv",
    "to": "tuː", "in": "ɪn", "is": "ɪz", "was": "wʌz", "are": "ɑːɹ",
    "be": "biː", "been": "bɪn", "he": "hiː", "she": "ʃiː", "it": "ɪt",
    "they": "ðeɪ", "we": "wiː", "you": "juː", "i": "aɪ", "that": "ðæt",
    "this": "ðɪs", "these": "ðiːz", "those": "ðoʊz", "for": "fɔːɹ",
    "on": "ɑːn", "with": "wɪð", "as": "æz", "at": "æt", "by": "baɪ",
    "from": "fɹʌm", "but": "bʌt", "not": "nɑːt", "or": "ɔːɹ",
    "have": "hæv", "has": "hæz", "had": "hæd", "his": "hɪz", "her": "hɜː",
    "their": "ðɛɹ", "there": "ðɛɹ", "what": "wʌt", "when": "wɛn",
    "where": "wɛɹ", "who": "huː", "which": "wɪtʃ", "why": "waɪ",
    "how": "haʊ", "all": "ɔːl", "one": "wˈʌn", "two": "tˈuː",
    "three": "θɹˈiː", "four": "fˈoːɹ", "five": "fˈaɪv", "six": "sˈɪks",
    "seven": "sˈɛvən", "eight": "ˈeɪt", "nine": "nˈaɪn", "ten": "tˈɛn",
    "do": "duː", "does": "dʌz", "did": "dɪd", "done": "dʌn",
    "would": "wʊd", "could": "kʊd", "should": "ʃʊd", "said": "sɛd",
    "says": "sɛz", "were": "wɜː", "will": "wɪl", "can": "kæn",
    "been": "bɪn", "some": "sʌm", "come": "kʌm", "comes": "kʌmz",
    "once": "wʌns", "so": "soʊ", "no": "noʊ", "go": "ɡoʊ", "my": "maɪ",
    "me": "miː", "us": "ʌs", "our": "aʊɚ", "your": "jʊɹ", "its": "ɪts",
    "them": "ðɛm", "than": "ðæn", "then": "ðɛn", "now": "naʊ",
    "new": "nˈuː", "also": "ˈɔːlsoʊ", "only": "ˈoʊnli", "other": "ˈʌðɚ",
    "into": "ˈɪntʊ", "over": "ˈoʊvɚ", "people": "pˈiːpəl",
    "because": "bɪkˈʌz", "through": "θɹuː", "again": "ɐɡˈɛn",
    "against": "ɐɡˈɛnst", "very": "vˈɛɹi", "any": "ˈɛni", "many": "mˈɛni",
    "water": "wˈɔːɾɚ", "cow": "kˈaʊ", "young": "jˈʌŋ", "quiet": "kwˈaɪət", "cycle": "sˈaɪkəl", "zero": "zˈɪɹoʊ", "great": "ɡɹˈeɪt", "before": "bɪfˈoːɹ",
    "says": "sɛz", "own": "ˈoʊn", "too": "tuː", "know": "nˈoʊ",
    "knows": "nˈoʊz", "knew": "nˈuː", "thought": "θˈɔːt", "though": "ðoʊ",
    "enough": "ɪnˈʌf", "eyes": "ˈaɪz", "eye": "ˈaɪ", "heart": "hˈɑːɹt",
    "world": "wˈɜːld", "word": "wˈɜːd", "work": "wˈɜːk", "first": "fˈɜːst",
    "here": "hɪɹ", "out": "aʊt", "about": "ɐbˈaʊt", "up": "ʌp",
    "down": "dˈaʊn", "day": "dˈeɪ", "night": "nˈaɪt", "light": "lˈaɪt",
    "right": "ɹˈaɪt", "old": "ˈoʊld", "good": "ɡˈʊd", "little": "lˈɪɾəl",
    "after": "ˈæftɚ", "never": "nˈɛvɚ", "always": "ˈɔːlweɪz",
    "away": "ɐwˈeɪ", "every": "ˈɛvɹi", "under": "ˈʌndɚ",
    "between": "bɪtwˈiːn", "both": "boʊθ", "while": "waɪl",
    "something": "sˈʌmθɪŋ", "nothing": "nˈʌθɪŋ", "being": "bˈiːɪŋ",
    "upon": "əpˈɑːn", "made": "mˈeɪd", "make": "mˈeɪk", "like": "lˈaɪk",
    "time": "tˈaɪm", "years": "jˈɪɹz", "year": "jˈɪɹ", "way": "wˈeɪ",
    "says": "sɛz", "mr": "mˈɪstɚ", "mrs": "mˈɪsɪz", "dr": "dˈɑːktɚ",
    "st": "seɪnt", "one's": "wʌnz", "o'clock": "əklˈɑːk",
    # irregular core vocabulary the letter-to-sound rules cannot carry
    # (same role as the reference's ttab lexicon, phonemes.py:116-118)
    "business": "bˈɪznəs", "busy": "bˈɪzi", "sugar": "ʃˈʊɡɚ",
    "usual": "jˈuːʒuəl", "usually": "jˈuːʒuəli", "science": "sˈaɪəns",
    "ocean": "ˈoʊʃən", "island": "ˈaɪlənd", "iron": "ˈaɪɚn",
    "answer": "ˈænsɚ", "hour": "ˈaʊɚ", "honest": "ˈɑːnəst",
    "friend": "fɹˈɛnd", "beautiful": "bjˈuːɾɪfəl", "woman": "wˈʊmən",
    "women": "wˈɪmɪn", "month": "mˈʌnθ", "money": "mˈʌni",
    "mother": "mˈʌðɚ", "brother": "bɹˈʌðɚ", "another": "ɐnˈʌðɚ",
    "son": "sˈʌn", "won": "wˈʌn", "ton": "tˈʌn", "front": "fɹˈʌnt",
    "love": "lˈʌv", "gone": "ɡˈɔːn", "none": "nˈʌn", "blood": "blˈʌd",
    "flood": "flˈʌd", "foot": "fˈʊt", "wolf": "wˈʊlf", "whose": "huːz",
    "whom": "huːm", "aunt": "ˈænt", "laugh": "lˈæf", "cough": "kˈɑːf",
    "rough": "ɹˈʌf", "tough": "tˈʌf", "stage": "stˈeɪdʒ",
    "page": "pˈeɪdʒ", "cage": "kˈeɪdʒ", "age": "ˈeɪdʒ",
    "heard": "hˈɜːd", "early": "ˈɜːli", "earth": "ˈɜːθ",
    "learn": "lˈɜːn", "search": "sˈɜːtʃ", "pizza": "pˈiːtsə",
    "lion": "lˈaɪən", "quiet": "kwˈaɪət", "area": "ˈɛɹiə",
    "idea": "aɪdˈiːə", "piano": "piːˈænoʊ", "radio": "ɹˈeɪdiˌoʊ",
    "video": "vˈɪdiˌoʊ", "period": "pˈɪɹiəd", "series": "sˈɪɹiz",
    "serious": "sˈɪɹiəs", "theory": "θˈɪɹi", "museum": "mjuːzˈiːəm",
    "create": "kɹiːˈeɪt", "january": "dʒˈænjuˌɛɹi",
    "february": "fˈɛbjuˌɛɹi", "wednesday": "wˈɛnzdeɪ",
    "tuesday": "tˈuːzdeɪ", "breakfast": "bɹˈɛkfəst",
    "chocolate": "tʃˈɔːklət", "vegetable": "vˈɛdʒtəbəl",
    "interesting": "ˈɪntɹəstɪŋ", "comfortable": "kˈʌmftɚbəl",
    "colonel": "kˈɜːnəl", "stomach": "stˈʌmək", "tongue": "tˈʌŋ",
    "heart": "hˈɑːɹt", "heavy": "hˈɛvi", "ready": "ɹˈɛdi",
    "head": "hˈɛd", "dead": "dˈɛd", "death": "dˈɛθ", "bread": "bɹˈɛd",
    "breath": "bɹˈɛθ", "weather": "wˈɛðɚ", "feather": "fˈɛðɚ",
    "leather": "lˈɛðɚ", "measure": "mˈɛʒɚ", "pleasure": "plˈɛʒɚ",
    "treasure": "tɹˈɛʒɚ", "sweater": "swˈɛɾɚ", "instead": "ɪnstˈɛd",
    "meant": "mˈɛnt", "health": "hˈɛlθ", "wealth": "wˈɛlθ",
    "jealous": "dʒˈɛləs", "ocean": "ˈoʊʃən", "door": "dˈoːɹ",
    "floor": "flˈoːɹ", "poor": "pˈʊɹ", "half": "hˈæf", "calm": "kˈɑːm",
    "walk": "wˈɔːk", "talk": "tˈɔːk", "chalk": "tʃˈɔːk",
    "would've": "wʊdəv", "give": "ɡˈɪv", "gives": "ɡˈɪvz",
    "live": "lˈɪv", "lived": "lˈɪvd", "liver": "lˈɪvɚ",
    "river": "ɹˈɪvɚ", "even": "ˈiːvən", "evening": "ˈiːvnɪŋ",
    "english": "ˈɪŋɡlɪʃ", "engine": "ˈɛndʒən",
    "engineer": "ˌɛndʒənˈɪɹ", "orange": "ˈɔːɹəndʒ",
    "language": "lˈæŋɡwɪdʒ", "image": "ˈɪmədʒ", "village": "vˈɪlədʒ",
    "garage": "ɡɚɹˈɑːʒ", "machine": "məʃˈiːn", "chef": "ʃˈɛf",
    "anchor": "ˈæŋkɚ", "echo": "ˈɛkoʊ", "school": "skˈuːl",
    "character": "kˈɛɹəktɚ", "chemistry": "kˈɛməstɹi",
    "christmas": "kɹˈɪsməs", "chorus": "kˈoːɹəs", "ache": "ˈeɪk",
    "headache": "hˈɛdeɪk", "minute": "mˈɪnɪt", "juice": "dʒˈuːs",
    "fruit": "fɹˈuːt", "suit": "sˈuːt", "build": "bˈɪld",
    "built": "bˈɪlt", "guide": "ɡˈaɪd", "guitar": "ɡɪtˈɑːɹ",
    "guard": "ɡˈɑːɹd", "guess": "ɡˈɛs", "guest": "ɡˈɛst",
    "tomb": "tˈuːm", "comb": "kˈoʊm", "climb": "klˈaɪm",
    "thumb": "θˈʌm", "debt": "dˈɛt", "doubt": "dˈaʊt",
    "receipt": "ɹɪsˈiːt", "castle": "kˈæsəl", "listen": "lˈɪsən",
    "often": "ˈɔːfən", "soften": "sˈɔːfən", "whistle": "wˈɪsəl",
    "muscle": "mˈʌsəl", "scene": "sˈiːn", "scissors": "sˈɪzɚz",
    "sword": "sˈoːɹd", "two": "tˈuː", "shoe": "ʃˈuː", "does": "dˈʌz",
    "goes": "ɡˈoʊz", "shoes": "ʃˈuːz", "canoe": "kənˈuː",
    "choir": "kwˈaɪɚ", "one": "wˈʌn", "onion": "ˈʌnjən",
    "monkey": "mˈʌŋki", "monday": "mˈʌndeɪ", "london": "lˈʌndən",
    "nothing": "nˈʌθɪŋ", "dozen": "dˈʌzən", "cousin": "kˈʌzən",
    "country": "kˈʌntɹi", "couple": "kˈʌpəl", "trouble": "tɹˈʌbəl",
    "double": "dˈʌbəl", "touch": "tˈʌtʃ", "southern": "sˈʌðɚn",
    "enough": "ɪnˈʌf", "among": "əmˈʌŋ", "come": "kˈʌm",
    "become": "bɪkˈʌm", "welcome": "wˈɛlkəm", "someone": "sˈʌmwʌn",
    "something": "sˈʌmθɪŋ", "stomach": "stˈʌmək", "oven": "ˈʌvən",
    "govern": "ɡˈʌvɚn", "government": "ɡˈʌvɚmənt", "above": "əbˈʌv",
    "glove": "ɡlˈʌv", "shovel": "ʃˈʌvəl", "cover": "kˈʌvɚ",
    "color": "kˈʌlɚ", "company": "kˈʌmpəni", "wonder": "wˈʌndɚ",
    "wonderful": "wˈʌndɚfəl", "won't": "woʊnt", "pretty": "pɹˈɪɾi",
    "bury": "bˈɛɹi", "very": "vˈɛɹi", "eleven": "ɪlˈɛvən",
    "second": "sˈɛkənd", "seven": "sˈɛvən", "sew": "sˈoʊ",
    "angel": "ˈeɪndʒəl", "giant": "dʒˈaɪənt", "vein": "vˈeɪn",
    "eyebrow": "ˈaɪbɹaʊ", "eye": "ˈaɪ", "homework": "hˈoʊmwɜːk",
    "firework": "fˈaɪɚwɜːk", "keyboard": "kˈiːboːɹd",
    "schedule": "skˈɛdʒuːl", "rhythm": "ɹˈɪðəm",
    "restaurant": "ɹˈɛstɚɹɑːnt", "soldier": "sˈoʊldʒɚ",
    "fuel": "fjˈuːəl", "marriage": "mˈɛɹɪdʒ", "grey": "ɡɹˈeɪ",
    "hey": "heɪ", "obey": "oʊbˈeɪ", "prey": "pɹˈeɪ",
    "vineyard": "vˈɪnjɚd", "courtesy": "kˈɜːtəsi",
    "gasoline": "ɡˈæsəliːn", "society": "səsˈaɪəti",
    "stranger": "stɹˈeɪndʒɚ", "passenger": "pˈæsəndʒɚ",
    "danger": "dˈeɪndʒɚ", "dangerous": "dˈeɪndʒɚəs",
    "manager": "mˈænədʒɚ", "finger": "fˈɪŋɡɚ", "anger": "ˈæŋɡɚ",
    "hunger": "hˈʌŋɡɚ", "singer": "sˈɪŋɚ", "tongue": "tˈʌŋ",
    "behavior": "bɪhˈeɪvjɚ", "emergency": "ɪmˈɜːdʒənsi",
    "razor": "ɹˈeɪzɚ", "paper": "pˈeɪpɚ", "label": "lˈeɪbəl",
    "basic": "bˈeɪsɪk", "famous": "fˈeɪməs", "nature": "nˈeɪtʃɚ",
    "navy": "nˈeɪvi", "lady": "lˈeɪdi", "crazy": "kɹˈeɪzi",
    "baby": "bˈeɪbi", "bacon": "bˈeɪkən", "apron": "ˈeɪpɹən",
    "horizon": "hɚɹˈaɪzən", "siren": "sˈaɪɹən", "pirate": "pˈaɪɹət",
    "diamond": "dˈaɪmənd", "vitamin": "vˈaɪɾəmən",
    "environment": "ɪnvˈaɪɹənmənt", "item": "ˈaɪɾəm",
    "tomorrow": "təmˈɑːɹoʊ", "tomato": "təmˈeɪɾoʊ",
    "potato": "pətˈeɪɾoʊ", "banana": "bənˈænə", "sofa": "sˈoʊfə",
    "motor": "mˈoʊɾɚ", "motorcycle": "mˈoʊɾɚsaɪkəl",
    "moment": "mˈoʊmənt", "open": "ˈoʊpən", "over": "ˈoʊvɚ",
    "ocean": "ˈoʊʃən", "total": "tˈoʊɾəl", "local": "lˈoʊkəl",
    "hotel": "hoʊtˈɛl", "program": "pɹˈoʊɡɹæm", "photo": "fˈoʊɾoʊ",
    "calculator": "kˈælkjəleɪɾɚ", "excellent": "ˈɛksələnt",
    "analysis": "ənˈæləsəs", "eraser": "ɪɹˈeɪsɚ",
    "american": "əmˈɛɹəkən", "opportunity": "ˌɑːpɚtˈuːnəɾi",
    "similar": "sˈɪməlɚ", "popular": "pˈɑːpjəlɚ",
    "professor": "pɹəfˈɛsɚ", "resource": "ɹˈiːsoːɹs",
    "jealousy": "dʒˈɛləsi", "geography": "dʒiˈɑːɡɹəfi",
    "technology": "tɛknˈɑːlədʒi", "receive": "ɹɪsˈiːv",
    "security": "sɪkjˈʊɹəɾi", "material": "mətˈɪɹiəl",
    "experience": "ɪkspˈɪɹiəns", "experiment": "ɪkspˈɛɹəmənt",
    # r5: frequent words whose stress/reduction pattern the rules cannot
    # derive (unstressed-prefix verbs, initial-stress nouns with irregular
    # vowels, loanwords) — General American, espeak-flavoured IPA
    "wind": "wˈɪnd", "winds": "wˈɪndz",
    "study": "stˈʌdi", "service": "sˈɜːvəs", "father": "fˈɑːðɚ",
    "community": "kəmjˈuːnəɾi", "president": "pɹˈɛzədɛnt",
    "information": "ˌɪnfɚmˈeɪʃən", "office": "ˈɔːfəs",
    "research": "ɹˈiːsɜːtʃ", "air": "ˈɛɹ", "college": "kˈɑːlɪdʒ",
    "interest": "ˈɪntɹəst", "effect": "ɪfˈɛkt", "control": "kəntɹˈoʊl",
    "development": "dɪvˈɛləpmənt", "police": "pəlˈiːs",
    "decision": "dɪsˈɪʒən", "value": "vˈæljuː", "director": "dɚɹˈɛktɚ",
    "position": "pəzˈɪʃən", "record": "ɹˈɛkɚd", "event": "ɪvˈɛnt",
    "official": "əfˈɪʃəl", "court": "kˈɔːɹt", "figure": "fˈɪɡjɚ",
    "data": "dˈeɪɾə", "practice": "pɹˈæktəs", "product": "pɹˈɑːdəkt",
    "patient": "pˈeɪʃənt", "movie": "mˈuːvi", "support": "səpˈɔːɹt",
    "computer": "kəmpjˈuːɾɚ", "source": "sˈɔːɹs",
    "subject": "sˈʌbdʒɪkt", "husband": "hˈʌzbənd",
    "congress": "kˈɑːŋɡɹəs", "knowledge": "nˈɑːlɪdʒ",
    "economy": "ɪkˈɑːnəmi", "financial": "fənˈænʃəl",
    "agency": "ˈeɪdʒənsi", "camera": "kˈæmɹə", "animal": "ˈænəməl",
    "budget": "bˈʌdʒɪt", "collection": "kəlˈɛkʃən",
    "hospital": "hˈɑːspɪɾəl", "medium": "mˈiːdiəm",
    "account": "əkˈaʊnt", "region": "ɹˈiːdʒən", "surface": "sˈɜːfəs",
    "election": "ɪlˈɛkʃən", "quality": "kwˈɑːləɾi",
    "challenge": "tʃˈæləndʒ", "article": "ˈɑːɹɾəkəl",
    "response": "ɹɪspˈɑːns", "statement": "stˈeɪtmənt",
    "success": "səksˈɛs", "institution": "ˌɪnstɪtˈuːʃən",
    "growth": "ɡɹˈoʊθ", "ability": "əbˈɪləɾi", "reality": "ɹiˈæləɾi",
    "direction": "dɚɹˈɛkʃən", "concern": "kənsˈɜːn", "dog": "dˈɔːɡ",
    "bear": "bˈɛɹ", "rabbit": "ɹˈæbət", "chicken": "tʃˈɪkən",
    "elephant": "ˈɛləfənt", "hundred": "hˈʌndɹəd",
    "thousand": "θˈaʊzənd", "fourth": "fˈɔːɹθ", "thursday": "θˈɜːzdeɪ",
    "friday": "fɹˈaɪdeɪ", "april": "ˈeɪpɹəl", "june": "dʒˈuːn",
    "july": "dʒuːlˈaɪ", "august": "ˈɔːɡəst", "october": "ɑːktˈoʊbɚ",
    "november": "noʊvˈɛmbɚ", "autumn": "ˈɔːɾəm", "hear": "hˈiːɹ",
    "break": "bɹˈeɪk", "push": "pˈʊʃ", "pull": "pˈʊl", "lose": "lˈuːz",
    "arrive": "ɚɹˈaɪv", "continue": "kəntˈɪnjuː", "appear": "əpˈɪɹ",
    "forget": "fɚɡˈɛt", "describe": "dɪskɹˈaɪb", "agree": "əɡɹˈiː",
    "refuse": "ɹɪfjˈuːz", "offer": "ˈɔːfɚ", "promise": "pɹˈɑːməs",
    "suggest": "səɡdʒˈɛst", "reply": "ɹɪplˈaɪ", "afraid": "əfɹˈeɪd",
    "excited": "ɪksˈaɪɾɪd", "narrow": "nˈɛɹoʊ", "smooth": "smˈuːð",
    "expensive": "ɪkspˈɛnsɪv", "full": "fˈʊl", "closed": "klˈoʊzd",
    "difficult": "dˈɪfəkəlt", "important": "ɪmpˈɔːɹtənt",
    "possible": "pˈɑːsəbəl", "impossible": "ɪmpˈɑːsəbəl",
    "necessary": "nˈɛsəsɛɹi", "available": "əvˈeɪləbəl",
    "different": "dˈɪfɹənt", "usual": "jˈuːʒuəl", "perfect": "pˈɜːfɪkt",
    "handsome": "hˈænsəm", "terrible": "tˈɛɹəbəl",
    "horrible": "hˈɔːɹəbəl", "false": "fˈɔːls", "correct": "kɚɹˈɛkt",
    "careful": "kˈɛɹfəl", "pear": "pˈɛɹ", "strawberry": "stɹˈɔːbɛɹi",
    "carrot": "kˈɛɹət", "honey": "hˈʌni", "salad": "sˈæləd",
    "pasta": "pˈɑːstə", "cookie": "kˈʊki", "kitchen": "kˈɪtʃən",
    "garden": "ɡˈɑːɹdən", "stairs": "stˈɛɹz", "chair": "tʃˈɛɹ",
    "drawer": "dɹˈɔːɹ", "bowl": "bˈoʊl", "wallet": "wˈɑːlət",
    "button": "bˈʌʔən", "necklace": "nˈɛkləs",
    "bracelet": "bɹˈeɪslət", "glasses": "ɡlˈæsəz",
    "umbrella": "əmbɹˈɛlə", "hair": "hˈɛɹ", "forehead": "fˈɔːɹhɛd",
    "ear": "ˈiːɹ", "shoulder": "ʃˈoʊldɚ", "toe": "tˈoʊ",
    "mountain": "mˈaʊntən", "forest": "fˈɔːɹəst", "desert": "dˈɛzɚt",
    "bush": "bˈʊʃ", "cedar": "sˈiːdɚ", "planet": "plˈænət",
    "wood": "wˈʊd", "wool": "wˈʊl", "cement": "səmˈɛnt",
    "concrete": "kˈɑːnkɹiːt", "palace": "pˈæləs", "cottage": "kˈɑːɾɪdʒ",
    "cabin": "kˈæbən", "airport": "ˈɛɹpɔːɹt", "bicycle": "bˈaɪsɪkəl",
    "pilot": "pˈaɪlət", "lawyer": "lˈɔːjɚ", "butcher": "bˈʊtʃɚ",
    "carpenter": "kˈɑːɹpəntɚ", "plumber": "plˈʌmɚ",
    "electrician": "ɪlɛktɹˈɪʃən", "scientist": "sˈaɪəntəst",
    "artist": "ˈɑːɹɾəst", "poet": "pˈoʊət", "musician": "mjuːzˈɪʃən",
    "secretary": "sˈɛkɹətɛɹi", "librarian": "laɪbɹˈɛɹiən",
    "ghost": "ɡˈoʊst", "wizard": "wˈɪzɚd", "fairy": "fˈɛɹi",
    "hero": "hˈɪɹoʊ", "audience": "ˈɑːdiəns", "citizen": "sˈɪɾəzən",
    "human": "hjˈuːmən", "teenager": "tˈiːneɪdʒɚ", "infant": "ˈɪnfənt",
    "uncle": "ˈʌŋkəl", "nephew": "nˈɛfjuː", "vacation": "veɪkˈeɪʃən",
    "journey": "dʒˈɜːni", "travel": "tɹˈævəl", "compass": "kˈʌmpəs",
    "height": "hˈaɪt", "length": "lˈɛŋkθ", "degree": "dɪɡɹˈiː",
    "temperature": "tˈɛmpɹətʃɚ", "climate": "klˈaɪmət",
    "harvest": "hˈɑːɹvəst", "meadow": "mˈɛdoʊ", "orchard": "ˈɔːɹtʃɚd",
    "restaurant": "ɹˈɛstɚɹɑːnt", "motel": "moʊtˈɛl",
    "theater": "θˈiːəɾɚ", "library": "lˈaɪbɹɛɹi", "circus": "sˈɜːkəs",
    "stadium": "stˈeɪdiəm", "gym": "dʒˈɪm", "doll": "dˈɑːl",
    "balloon": "bəlˈuːn", "violin": "vaɪəlˈɪn", "opera": "ˈɑːpɹə",
    "ballet": "bælˈeɪ", "photograph": "fˈoʊɾəɡɹæf",
    "internet": "ˈɪntɚnɛt", "email": "ˈiːmeɪl", "message": "mˈɛsɪdʒ",
    "package": "pˈækɪdʒ", "parade": "pɚɹˈeɪd",
    "electricity": "ɪlɛktɹˈɪsəɾi", "reflection": "ɹɪflˈɛkʃən",
    "horizon": "hɚɹˈaɪzən", "sunset": "sˈʌnsɛt", "today": "tədˈeɪ",
    "calendar": "kˈæləndɚ", "appointment": "əpˈɔɪntmənt",
    "discussion": "dɪskˈʌʃən", "argument": "ˈɑːɹɡjəmənt",
    "debate": "dəbˈeɪt", "diploma": "dɪplˈoʊmə",
    "university": "ˌjuːnəvˈɜːsəɾi", "laboratory": "lˈæbɹətɔːɹi",
    "theory": "θˈiːɚɹi", "formula": "fˈɔːɹmjələ",
    "equation": "ɪkwˈeɪʒən", "biology": "baɪˈɑːlədʒi",
    "astronomy": "əstɹˈɑːnəmi", "medicine": "mˈɛdəsən",
    "fever": "fˈiːvɚ", "injury": "ˈɪndʒɚi", "wound": "wˈuːnd",
    "ambulance": "ˈæmbjələns", "signal": "sˈɪɡnəl", "safety": "sˈeɪfti",
    "escape": "ɪskˈeɪp", "weapon": "wˈɛpən", "arrow": "ˈæɹoʊ",
    "bullet": "bˈʊlət", "ally": "ˈælaɪ", "freedom": "fɹˈiːdəm",
    "justice": "dʒˈʌstəs", "courage": "kˈɜːɹɪdʒ", "honor": "ˈɑːnɚ",
    "guilt": "ɡˈɪlt", "patience": "pˈeɪʃəns", "wisdom": "wˈɪzdəm",
    "kindness": "kˈaɪndnəs", "miracle": "mˈɪɹəkəl", "secret": "sˈiːkɹət",
    "gossip": "ɡˈɑːsəp", "legend": "lˈɛdʒənd", "laughter": "lˈæftɚ",
    "applause": "əplˈɔːz", "silence": "sˈaɪləns", "accent": "ˈæksɛnt",
    "alphabet": "ˈælfəbɛt", "poem": "pˈoʊəm",
    "dictionary": "dˈɪkʃənɛɹi", "journal": "dʒˈɜːnəl",
    "diary": "dˈaɪɚi", "pencil": "pˈɛnsəl", "abacus": "ˈæbəkəs",
    "atlas": "ˈætləs", "case": "kˈeɪs", "note": "nˈoʊt",
    "news": "nˈuːz", "paper": "pˈeɪpɚ", "book": "bˈʊk",
    "sun": "sˈʌn", "rise": "ɹˈaɪz", "set": "sˈɛt", "ware": "wˈɛɹ",
    "house": "hˈaʊs", "grand": "ɡɹˈænd", "fore": "fˈoːɹ",
    "suitcase": "sˈuːtkeɪs", "grandson": "ɡɹˈændsʌn",
    "family": "fˈæməli", "president": "pɹˈɛzədɛnt",
    "building": "bˈɪldɪŋ", "congress": "kˈɑːŋɡɹəs",
}

# context-sensitive letter-to-sound rules; first match wins.
# format: (left-context, grapheme, right-context, phonemes)
# '#' = word boundary, 'V' = any vowel letter, 'C' = any consonant letter.
LTS_RULES = [
    # --- r5 additions: classes measured against the cmudict golden ---
    # long-vowel clusters (child, kind, sign, old, bolt, roll)
    ("", "ild", "#", "aɪld"), ("", "ild", "r", "ɪld"),
    ("", "ind", "#", "aɪnd"), ("", "ind", "s#", "aɪnd"),
    ("", "ign", "", "aɪn"), ("", "old", "", "oʊld"),
    ("", "olt", "", "oʊlt"), ("", "oll", "#", "oʊl"),
    # final y after an onset-only spelling is the diphthong (fly, try)
    ("#C", "y", "#", "aɪ"), ("#CC", "y", "#", "aɪ"),
    ("#CCC", "y", "#", "aɪ"),
    ("", "uy", "", "aɪ"), ("", "y", "Ce#", "aɪ"), ("", "ye", "#", "aɪ"),
    # u-class spellings (view, value, blue, truth)
    ("", "iew", "", "juː"),
    ("l", "ue", "#", "uː"), ("r", "ue", "#", "uː"), ("", "ue", "#", "juː"),
    ("", "u", "th#", "uː"),
    # broad-O contexts (wall, talk, salt, war, long, loss, off)
    ("", "all", "#", "ɔːl"), ("", "all", "s#", "ɔːl"),
    ("", "alk", "", "ɔːk"), ("", "alt", "", "ɔːlt"),
    ("w", "ar", "#", "ɔːɹ"), ("w", "ar", "C", "ɔːɹ"),
    ("w", "or", "C", "ɜː"),
    ("w", "atch", "", "ɑːtʃ"),
    ("", "ong", "#", "ɔːŋ"), ("", "ong", "s#", "ɔːŋ"),
    ("", "oss", "#", "ɔːs"), ("", "off", "#", "ɔːf"),
    # r-colored / pre-r vowel clusters (early, near, here, carry, sorry)
    ("", "ear", "C", "ɜː"), ("", "ear", "#", "ɪɹ"), ("", "ear", "V", "ɪɹ"),
    ("", "eer", "", "ɪɹ"), ("", "ere", "#", "ɪɹ"),
    ("#", "arr", "", "əɹ"), ("", "arr", "V", "æɹ"),
    ("", "err", "V", "ɛɹ"), ("", "orr", "V", "ɑːɹ"), ("", "irr", "V", "ɪɹ"),
    # palatalisation before unstressed u (situation, graduate, question)
    ("", "stion", "", "stʃən"),
    ("", "tu", "V", "tʃu"), ("", "du", "V", "dʒu"),
    # silent clusters (climb, autumn, listen, castle)
    ("", "mb", "#", "m"), ("", "mn", "#", "m"),
    ("", "sten", "#", "sən"), ("", "stle", "#", "səl"),
    ("", "uage", "#", "wɪdʒ"),
    # word-initial unstressed a- before an open syllable (about, ago,
    # ability); doubled-consonant attachments (attack, attention, affair)
    ("#", "att", "", "ət"), ("#", "aff", "", "əf"),
    ("#", "a", "CV", "ə"),
    ("", "a", "#", "ə"),
    ("ff", "or", "t#", "ɚ"),
    ("mf", "or", "t#", "ɚ"),
    ("", "sear", "", "sɜː"),
    ("#", "a", "gen", "eɪ"),
    ("", "ssue", "", "ʃuː"),
    ("", "edu", "", "ɛdʒə"),
    ("", "gy", "#", "dʒi"),
    ("", "llion", "", "ljən"), ("", "nion", "", "njən"),
    ("", "nge", "#", "ndʒ"),
    ("r", "ive", "#", "aɪv"), ("l", "ive", "#", "aɪv"),
    ("f", "ive", "#", "aɪv"), ("h", "ive", "#", "aɪv"),
    ("v", "ive", "#", "aɪv"), ("", "ive", "#", "ɪv"),
    ("m", "edi", "", "iːdi"),
    ("", "ire", "", "aɪɚ"),
    ("", "our", "#", "aʊɚ"),
    ("", "ea", "lth", "ɛ"), ("", "ead", "y", "ɛd"),
    ("", "oup", "", "uːp"),
    ("oo", "se", "#", "z"),
    ("", "ose", "#", "oʊz"),
    ("", "sb", "", "zb"),
    ("", "cc", "ee", "ks"), ("", "cc", "e", "ks"), ("", "cc", "i", "ks"),
    ("", "cc", "", "k"),
    ("#", "ex", "V", "ɪɡz"),
    ("#", "gh", "", "ɡ"),
    ("", "age", "#", "ɪdʒ"),
    ("", "oise", "", "ɔɪz"), ("", "ease", "#", "iːz"),
    ("", "eese", "#", "iːz"), ("", "uise", "#", "uːz"),
    ("", "ause", "", "ɔːz"), ("", "aise", "#", "eɪz"),
    ("", "ise", "#", "aɪz"),
    ("z", "ine", "#", "iːn"), ("cc", "ine", "#", "iːn"),
    ("r", "ine", "#", "iːn"),
    ("", "gery", "#", "dʒɚi"),
    ("rt", "ain", "#", "ən"), ("pt", "ain", "#", "ən"),
    ("ll", "ain", "#", "ən"), ("it", "ain", "#", "ən"),
    ("", "i", "CeC#", "aɪ"), ("", "a", "CeC#", "eɪ"),
    ("", "i", "Cle#", "aɪ"), ("", "a", "Cle#", "eɪ"),
    ("", "o", "Cle#", "oʊ"),
    # --- end r5 additions ---
    # tense vowel before the -tion/-ture suffixes (nation, nature)
    ("", "ation", "", "eɪʃən"),
    ("", "otion", "", "oʊʃən"),
    ("", "ution", "", "uːʃən"),
    ("", "ature", "#", "eɪtʃɚ"),
    ("", "ssion", "", "ʃən"),   # mission, passion
    ("", "tion", "", "ʃən"),
    ("", "sion", "", "ʒən"),
    ("", "ture", "#", "tʃɚ"),
    # Latinate palatalisation suffixes (musician, special, patient,
    # delicious, pressure, measure)
    ("", "cian", "", "ʃən"),
    ("", "cial", "", "ʃəl"),
    ("", "tial", "", "ʃəl"),
    ("", "cious", "", "ʃəs"),
    ("", "tious", "", "ʃəs"),
    ("", "cient", "", "ʃənt"),
    ("", "tient", "", "ʃənt"),
    ("", "tience", "", "ʃəns"),
    ("", "cience", "", "ʃəns"),
    ("", "ssure", "#", "ʃɚ"),
    ("", "sure", "#", "ʒɚ"),
    # vowel-reduced closing suffixes (famous, animal, statement, reason);
    # monosyllables that would be caught live in the lexicon
    ("", "ious", "#", "iəs"),
    ("", "eous", "#", "iəs"),
    ("", "ous", "#", "əs"),
    ("", "ian", "#", "iən"),
    ("", "ial", "#", "iəl"),
    ("", "ium", "#", "iəm"),
    ("", "ment", "#", "mənt"),
    ("", "ness", "#", "nəs"),
    ("", "less", "#", "ləs"),
    ("", "ful", "#", "fəl"),
    ("V", "al", "#", "əl"),
    ("C", "al", "#", "əl"),
    ("C", "on", "#", "ən"),
    ("#", "ex", "", "ɪks"),     # experience, expensive
    ("", "nging", "#", "ŋɪŋ"),  # singing, ringing: no hard g
    # doubled consonant letters are single phonemes
    ("", "bb", "", "b"), ("", "dd", "", "d"), ("", "ff", "", "f"),
    ("", "gg", "", "ɡ"), ("", "ll", "", "l"), ("", "mm", "", "m"),
    ("", "nn", "", "n"), ("", "pp", "", "p"), ("", "rr", "", "ɹ"),
    ("", "ss", "", "s"), ("", "tt", "V", "ɾ"), ("", "tt", "", "t"),
    ("", "zz", "", "z"),
    ("", "ought", "", "ɔːt"),
    ("", "aught", "", "ɔːt"),
    ("", "igh", "", "aɪ"),
    ("", "eigh", "", "eɪ"),
    ("", "ough", "#", "oʊ"),
    ("", "tch", "", "tʃ"),
    ("", "dge", "", "dʒ"),
    ("", "ck", "", "k"),
    ("", "wh", "", "w"),
    ("#", "kn", "", "n"),
    ("#", "wr", "", "ɹ"),
    ("#", "ps", "", "s"),
    ("", "ph", "", "f"),
    ("", "gh", "#", ""),
    ("", "sh", "", "ʃ"),
    ("", "ch", "", "tʃ"),
    ("", "th", "", "θ"),
    ("", "ng", "#", "ŋ"),
    ("", "ng", "", "ŋɡ"),
    ("", "n", "k", "ŋ"),        # think, bank
    ("", "qu", "", "kw"),
    ("", "oo", "k", "ʊ"),       # book, look, took
    ("", "oo", "", "uː"),
    ("", "ee", "", "iː"),
    ("", "ea", "", "iː"),
    ("", "ai", "", "eɪ"),
    ("", "ay", "", "eɪ"),
    ("", "oa", "", "oʊ"),
    ("", "ow", "#", "oʊ"),
    ("", "ow", "", "aʊ"),
    ("", "ou", "", "aʊ"),
    ("", "oi", "", "ɔɪ"),
    ("", "oy", "", "ɔɪ"),
    ("", "au", "", "ɔː"),
    ("", "aw", "", "ɔː"),
    ("", "ew", "", "uː"),
    # vowel+r before another vowel: true /ɹ/ onset, not an r-colored
    # nucleus (parent, american, miracle, security)
    ("", "ar", "V", "ɛɹ"),
    ("", "er", "V", "ɛɹ"),
    ("", "ir", "V", "ɪɹ"),
    ("", "ur", "V", "ʊɹ"),
    ("", "ar", "", "ɑːɹ"),
    ("", "er", "#", "ɚ"),
    ("", "er", "", "ɜː"),
    ("", "ir", "", "ɜː"),
    ("", "ur", "", "ɜː"),
    ("C", "or", "#", "ɚ"),     # unstressed final -or: doctor, mirror
    ("", "or", "", "ɔːɹ"),
    ("", "ange", "#", "eɪndʒ"),  # change, strange, range
    ("", "logy", "#", "lədʒi"),
    ("", "graphy", "#", "ɡɹəfi"),
    ("", "gion", "", "dʒən"),   # region, religion
    ("", "gious", "", "dʒəs"),
    ("", "gen", "", "dʒɛn"),    # generation; 'get' unaffected
    ("c", "ei", "", "iː"),      # receive, ceiling
    ("", "ei", "", "eɪ"),       # vein, weigh leftovers
    ("", "ie", "#", "aɪ"),      # tie, die
    ("", "ie", "", "iː"),       # believe, field, piece
    ("#d", "ia", "", "aɪə"),    # diary, diamond, dial
    ("", "ey", "#", "i"),       # journey, valley, kidney
    ("#", "re", "CV", "ɹɪ"),    # return, remain, result (desk-safe CV guard)
    ("#", "be", "CV", "bɪ"),    # behave, believe
    ("#", "de", "CV", "dɪ"),    # decide, decision
    ("", "ch", "n", "k"),       # technology
    ("", "ch", "r", "k"),       # chrome, christen
    ("", "a", "Ce#", "eɪ"),
    ("", "i", "Ce#", "aɪ"),
    ("", "o", "Ce#", "oʊ"),
    ("l", "u", "Ce#", "uː"),   # flute: no glide after l/r clusters
    ("r", "u", "Ce#", "uː"),
    ("", "u", "Ce#", "juː"),   # cute, mute: open-syllable u = /juː/
    # open-syllable u mid-word: /juː/ (music, community) with American
    # yod-dropping after coronals (student, news, rule, June)
    ("t", "u", "CV", "uː"), ("d", "u", "CV", "uː"),
    ("n", "u", "CV", "uː"), ("s", "u", "CV", "uː"),
    ("l", "u", "CV", "uː"), ("r", "u", "CV", "uː"),
    ("z", "u", "CV", "uː"), ("j", "u", "CV", "uː"),
    ("", "u", "CV", "juː"),
    ("C", "le", "#", "əl"),    # circle, little, table
    # past-tense -ed: /ɪd/ after t,d; /t/ after voiceless; /d/ otherwise.
    # Two-letter left contexts keep monosyllables (red, bed) untouched.
    ("t", "ed", "#", "ɪd"), ("d", "ed", "#", "ɪd"),
    ("Vs", "ed", "#", "d"),    # closed, surprised (s voiced -> /zd/)
    ("s", "ed", "#", "t"), ("k", "ed", "#", "t"), ("p", "ed", "#", "t"),
    ("f", "ed", "#", "t"), ("ch", "ed", "#", "t"), ("sh", "ed", "#", "t"),
    ("VC", "ed", "#", "d"), ("VCC", "ed", "#", "d"), ("V", "ed", "#", "d"),
    ("", "ure", "#", "jɚ"),    # figure
    ("", "e", "#", ""),        # silent final e
    ("", "o", "#", "oʊ"),      # final open o: photo, piano, hero
    ("", "y", "#", "i"),
    ("#", "y", "", "j"),
    ("", "y", "", "ɪ"),
    ("", "a", "", "æ"),
    ("", "e", "", "ɛ"),
    ("", "i", "", "ɪ"),
    ("", "o", "", "ɑː"),
    ("", "u", "", "ʌ"),
    ("", "c", "e", "s"),
    ("", "c", "i", "s"),
    ("", "c", "y", "s"),
    ("", "c", "", "k"),
    ("", "g", "e#", "dʒ"),
    ("", "x", "", "ks"),
    ("", "j", "", "dʒ"),
    ("", "b", "", "b"), ("", "d", "", "d"), ("", "f", "", "f"),
    ("", "g", "", "ɡ"), ("", "h", "", "h"), ("", "k", "", "k"),
    ("", "l", "", "l"), ("", "m", "", "m"), ("", "n", "", "n"),
    ("", "p", "", "p"), ("", "r", "", "ɹ"),
    ("", "s", "e#", "s"),      # final -se stays /s/ (case, house)
    ("V", "s", "V", "z"),      # intervocalic voicing: reason, music
    ("", "s", "", "s"),
    ("V", "t", "V", "ɾ"),      # American intervocalic flap: city, water
    ("", "t", "", "t"), ("", "v", "", "v"), ("", "w", "", "w"),
    ("", "z", "", "z"),
]


def _match_context(word: str, pos: int, ctx: str, after: bool) -> bool:
    if not ctx:
        return True
    if after:
        segment = word[pos:]
        for c in ctx:
            if c == "#":
                return segment == ""
            if not segment:
                return False
            ch, segment = segment[0], segment[1:]
            if c == "V" and ch not in "aeiouy":
                return False
            if c == "C" and ch in "aeiouy":
                return False
            if c not in "VC" and ch != c:
                return False
        return True
    segment = word[:pos]
    for c in reversed(ctx):
        if c == "#":
            return segment == ""
        if not segment:
            return False
        ch, segment = segment[-1], segment[:-1]
        if c == "V" and ch not in "aeiouy":
            return False
        if c == "C" and ch in "aeiouy":
            return False
        if c not in "VC" and ch != c:
            return False
    return True


# word-final suffix reductions applied to polysyllables in phoneme space:
# unstressed closing syllables centralise to schwa in General American
# (student, parent, level, market, system, quality).  Monosyllables (went,
# bell, get) are excluded by the nucleus count.
_REDUCE_SUFFIXES = [
    (2, "ɛnt", "ənt"), (2, "ɛns", "əns"), (2, "ɛm", "əm"), (2, "ɛl", "əl"),
    (2, "ɛt", "ət"), (2, "ɪti", "əti"), (2, "æns", "əns"),
    (3, "ɛɹi", "ɚi"), (3, "ɔːɹi", "ɚi"), (2, "dɔːm", "dəm"),
]

_DIPHTHONGS = ("aɪ", "aʊ", "eɪ", "oʊ", "ɔɪ", "ɪə", "eə", "ʊə")


def _nuclei(phonemes: str) -> int:
    """Count syllable nuclei: diphthongs are one unit; every other vowel
    character (plus optional length mark) is its own nucleus."""
    n = 0
    i = 0
    while i < len(phonemes):
        pair = phonemes[i:i + 2]
        if pair in _DIPHTHONGS:
            n += 1
            i += 2
        elif phonemes[i] in VOWELS and phonemes[i] != "ː":
            n += 1
            i += 1
        else:
            i += 1
        while i < len(phonemes) and phonemes[i] == "ː":
            i += 1
    return n


def _medial_reduce(phonemes: str) -> str:
    """Centralise the SECOND nucleus of an initial-stress polysyllable
    (galaxy, enemy, melody, universe): with primary stress on nucleus 1,
    a short nucleus 2 reduces to schwa in General American.  Words whose
    first nucleus already reduced (ə) carry stress later — untouched."""
    if _nuclei(phonemes) < 3:
        return phonemes
    spans = []
    i = 0
    while i < len(phonemes) and len(spans) < 3:
        pair = phonemes[i:i + 2]
        if pair in _DIPHTHONGS:
            spans.append((i, i + 2))
            i += 2
        elif phonemes[i] in VOWELS and phonemes[i] != "ː":
            j = i + 1
            while j < len(phonemes) and phonemes[j] == "ː":
                j += 1
            spans.append((i, j))
            i = j
        else:
            i += 1
    first = phonemes[spans[0][0]:spans[0][1]]
    s2, e2 = spans[1]
    second = phonemes[s2:e2]
    if first in ("ə", "ɚ", "ɐ") or second not in ("æ", "ɛ", "ɪ", "ɑː", "ʌ"):
        return phonemes
    return phonemes[:s2] + "ə" + phonemes[e2:]


def _reduce_unstressed(phonemes: str) -> str:
    n = _nuclei(phonemes)
    for min_n, old, new in _REDUCE_SUFFIXES:
        if n < min_n:
            continue
        if phonemes.endswith(old):
            phonemes = phonemes[: -len(old)] + new
            break
        if phonemes.endswith(old + "s"):
            phonemes = phonemes[: -len(old) - 1] + new + "s"
            break
    return _medial_reduce(phonemes)


def letter_to_sound(word: str) -> str:
    out = []
    pos = 0
    while pos < len(word):
        for left, grapheme, right, phonemes in LTS_RULES:
            if not word.startswith(grapheme, pos):
                continue
            if not _match_context(word, pos, left, after=False):
                continue
            if not _match_context(word, pos + len(grapheme), right, after=True):
                continue
            out.append(phonemes)
            pos += len(grapheme)
            break
        else:
            pos += 1  # drop unknown character
    return _reduce_unstressed("".join(out))


def add_stress(phonemes: str) -> str:
    """Primary stress on the first vowel.  espeak places the mark
    immediately before the stressed VOWEL, after the whole onset cluster
    (kˈæt, stɹˈiːt, kwˈɪk, fjˈuːtʃɚ) — measured against its output, not
    the textbook before-the-onset convention."""
    if "ˈ" in phonemes or "ˌ" in phonemes:
        return phonemes
    for i, ch in enumerate(phonemes):
        if ch in VOWELS:
            return phonemes[:i] + "ˈ" + phonemes[i:]
    return phonemes


def pluralize(phonemes: str) -> str:
    if not phonemes:
        return phonemes
    last = phonemes.rstrip("ː")[-1] if phonemes[-1] == "ː" else phonemes[-1]
    if last in "szʃʒ" or phonemes.endswith(("tʃ", "dʒ")):
        return phonemes + "əz"
    if last in VOWELS or phonemes[-1] == "ː":
        return phonemes + "z"
    if last in "ptkfθ":
        return phonemes + "s"
    return phonemes + "z"


_ESPEAK_FIXUPS = [
    (re.compile(r"ʧ"), "tʃ"),
    (re.compile(r"ʤ"), "dʒ"),
    (re.compile(r"ɫ"), "l"),
    (re.compile(r"i($|[^ː])"), r"iː\1"),
    (re.compile(r"ɑ($|[^ː])"), r"ɑː\1"),
    (re.compile(r"u($|[^ː])"), r"uː\1"),
    (re.compile(r"ɝ"), "ɜː"),
    (re.compile(r"ɨ"), "ɪ"),
]


def to_espeak(word: str) -> str:
    """Normalise generic American IPA to espeak's conventions (length
    marks, affricates) — role of TO_ESPEAK in the reference
    (lib/ttab/phonemes.py:24-55)."""
    for pattern, repl in _ESPEAK_FIXUPS:
        word = pattern.sub(repl, word)
    return word


class G2P:
    """text -> IPA phoneme string for the TextCleaner inventory."""

    def __init__(self, use_espeak: Optional[bool] = None):
        from .homographs import Homographs

        self.espeak = shutil.which("espeak-ng") or shutil.which("espeak")
        if use_espeak is False:
            self.espeak = None
        # learned (stacked) disambiguator when its committed weights are
        # present — A/B-measured above the rule scorer on the external
        # heteronym set (scripts/g2p_eval.py); rules otherwise
        classifier = None
        try:
            from .homograph_model import LearnedHomographClassifier

            classifier = LearnedHomographClassifier.load()
        except (OSError, ValueError):
            pass
        self.homographs = Homographs(classifier=classifier)

    def word(self, word: str) -> str:
        lower = word.lower()
        if lower in LEXICON:
            return LEXICON[lower]
        if lower.endswith("'s") and lower[:-2] in LEXICON:
            return pluralize(LEXICON[lower[:-2]])
        if lower.endswith("s") and lower[:-1] in LEXICON:
            return pluralize(LEXICON[lower[:-1]])
        # transparent compounds (notebook, newspaper, sunrise): phonemize
        # the halves independently so mid-word silent-e and stress behave
        # as at true word edges.  Both halves must be known words.
        if len(lower) >= 6 and lower.isalpha():
            for i in range(3, len(lower) - 2):
                a, b = lower[:i], lower[i:]
                if a in LEXICON and b in LEXICON:
                    return LEXICON[a] + LEXICON[b].replace("ˈ", "ˌ")
        return add_stress(letter_to_sound(lower))

    def __call__(self, text: str) -> str:
        if self.espeak:
            try:
                out = subprocess.run(
                    [self.espeak, "-q", "--ipa=3", "-v", "en-us", text],
                    capture_output=True, text=True, timeout=30,
                ).stdout
                return to_espeak(out.replace("_", "").strip())
            except Exception:
                pass
        tokens = re.findall(r"[A-Za-z']+|[,.;:?!()…\"“”—]", text)
        parts: List[str] = []
        for i, token in enumerate(tokens):
            if re.match(r"[A-Za-z']", token):
                resolved = self.homographs.resolve(
                    token, tokens[max(0, i - 3):i], tokens[i + 1:i + 3]
                )
                parts.append(resolved if resolved else self.word(token))
            else:
                parts.append(token)
        return " ".join(parts)
