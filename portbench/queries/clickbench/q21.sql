SELECT "SearchPhrase", MIN("URL") AS mn, COUNT(*) AS c FROM hits
WHERE "URL" LIKE '%google%' AND "SearchPhrase" <> ''
GROUP BY "SearchPhrase" ORDER BY c DESC LIMIT 10
